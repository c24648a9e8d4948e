"""The port's command-line tools, one module for each of the reference's
``scripts/`` of the same name, with its flags and output lines; each runs
as ``python -m jlm_tpu_torch.scripts.<name>``.  A tool that runs the model
takes ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  ``python -m jlm_tpu_torch.train`` stands for
``scripts/train.py``.
"""
