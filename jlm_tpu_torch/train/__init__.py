"""Training on one device: the trainer, its optimizer chain and checkpoints.

``python -m jlm_tpu_torch.train`` is the command-line entry point (the
flags of ``scripts/train.py``).
"""

from jlm_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from jlm_tpu_torch.train.trainer import Trainer, epoch_lr, train_lm  # noqa: F401
