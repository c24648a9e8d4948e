"""The port's multi-host launcher (``python -m
jlm_tpu_torch.scripts.launch_multihost``) on the CPU.

Mirrors tests/test_multiprocess.py: two separate processes form one
process group over ``tcp://`` (the coordinator's address, as on two
hosts), train a ``(data 2, vocab 1)`` mesh for one epoch and checkpoint
from rank 0; the checkpoint must equal one process's ``Trainer`` on the
same data, the port's and the JAX package's (params within 2e-4 abs +
2e-3 rel, as there; the logged dev perplexity within 1e-3 relative).  A
launch whose world does not match its mesh stops before any rendezvous.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = 32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(data, exp, timeout=300):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    argv = [sys.executable, "-m", "jlm_tpu_torch.scripts.launch_multihost",
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--data", data,
            "--exp", exp, "--mesh-data", "2", "--mesh-vocab", "1", "--num-layers", "1",
            "--hidden-size", str(HIDDEN), "--epochs", "1", "--device", "cpu"]
    procs = [subprocess.Popen(argv + ["--process-id", str(i)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
    return all(p.returncode == 0 for p in procs), logs


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from jlm_tpu_torch.scripts import prepare_data

    d = str(tmp_path_factory.mktemp("launch") / "data")
    prepare_data.main(["--out", d, "--synthetic-sentences", "4000", "--vocab-size", "50000"])
    return d


def test_two_process_launch_matches_single(data_dir, tmp_path):
    import jax

    from jlm_tpu.config import Config as JConfig
    from jlm_tpu.train import Trainer as JTrainer
    from jlm_tpu_torch.config import Config, pad_vocab_size
    from jlm_tpu_torch.data.io import load_dataset
    from jlm_tpu_torch.train import Trainer, checkpoint, load_checkpoint

    exp = str(tmp_path / "exp")
    ok, logs = _launch(data_dir, exp)
    if not ok:  # a fresh port and fresh processes once, as test_multiprocess.py
        print("first launch failed, retrying once:\n" + "\n".join(logs), flush=True)
        ok, logs = _launch(data_dir, exp)
    assert ok, "\n".join(logs)
    assert "backend gloo, world 2" in logs[0]

    vocab, train, dev, _ = load_dataset(data_dir)
    cfg = Config(vocab_size=pad_vocab_size(len(vocab), 1), num_layers=1, hidden_size=HIDDEN,
                 epochs=1)
    tr = Trainer(cfg, device="cpu")
    tr.run_epoch(train, 0)
    tr_j = JTrainer(JConfig(vocab_size=cfg.vocab_size, num_layers=1, hidden_size=HIDDEN,
                            epochs=1))
    tr_j.run_epoch(train, 0, jax.random.key(0))
    got, got_cfg = load_checkpoint(exp)
    assert (got_cfg.mesh_data, got_cfg.mesh_vocab) == (2, 1)
    got = checkpoint.flatten(got)
    for ref in (jax.tree.map(lambda t: t.detach().numpy(), tr.params),
                jax.tree.map(np.asarray, tr_j.params)):
        want = checkpoint.flatten(ref)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=2e-3,
                                       err_msg=k)
    (rec,) = checkpoint.read_log(exp)
    assert np.isfinite(rec["dev_ppl"])
    assert abs(rec["dev_ppl"] / tr.evaluate_ppl(dev) - 1) < 1e-3
    assert abs(rec["dev_ppl"] / tr_j.evaluate_ppl(dev) - 1) < 1e-3


@pytest.mark.parametrize("flags", [["--num-processes", "3"],
                                   ["--num-processes", "2", "--mesh-seq", "2",
                                    "--mesh-data", "2"]])
def test_launch_refuses_a_world_off_its_mesh(data_dir, tmp_path, flags):
    """A world of 3 for a (2, 1) mesh, and ``--mesh-seq`` beside an explicit
    ``--mesh-data``, stop before any rendezvous (no process group forms)."""
    import torch.distributed as dist

    from jlm_tpu_torch.scripts import launch_multihost

    argv = ["--coordinator", "127.0.0.1:1", "--process-id", "0", "--data", data_dir,
            "--exp", str(tmp_path / "exp"), "--mesh-data", "2", "--mesh-vocab", "1",
            "--device", "cpu"] + flags
    with pytest.raises((SystemExit, ValueError)):
        launch_multihost.main(argv)
    assert not dist.is_initialized() and not os.path.exists(str(tmp_path / "exp"))
