"""Multi-host launcher (counterpart of ``scripts/launch_multihost.py``).

One process per rank, the same invocation on every host but for
``--process-id``:

  # on every host i of N:
  python -m jlm_tpu_torch.scripts.launch_multihost --coordinator host0:8476 \\
      --num-processes N --process-id i \\
      --data data/ --exp experiments/h512-2l-100k --mesh-data 2 --mesh-vocab 4

``--coordinator host:port`` is rank 0's address: the process group forms
through ``tcp://host:port`` (``parallel.mesh.multihost_init``, which picks
the backend: ``nccl`` where every rank has a GPU of its own, ``gloo``
otherwise or with ``--device cpu``).  Each rank then builds its mesh,
``(data, vocab)`` or, with ``--mesh-seq``, the time-block pipeline's, and
runs :func:`jlm_tpu_torch.train.train_lm` on it (rank 0 writes the
checkpoints; ``--resume`` continues a crashed run).  Fails fast, on every
rank and before any rendezvous, when the world does not match the mesh.
"""

import argparse

import torch
import torch.distributed as dist

from jlm_tpu_torch.config import Config, pad_vocab_size
from jlm_tpu_torch.data.io import load_dataset
from jlm_tpu_torch.models.params import resolve_device
from jlm_tpu_torch.parallel.comm import rank_device
from jlm_tpu_torch.parallel.mesh import multihost_init
from jlm_tpu_torch.parallel.train_step import check_mesh_flags
from jlm_tpu_torch.train.trainer import rank_mesh, train_lm


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m jlm_tpu_torch.scripts.launch_multihost")
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--exp", required=True)
    ap.add_argument("--mesh-data", type=int, default=None, help="default 2 (1 with --mesh-seq)")
    ap.add_argument("--mesh-vocab", type=int, default=None, help="default 4 (1 with --mesh-seq)")
    ap.add_argument("--mesh-seq", type=int, default=1,
                    help="time-block pipeline ranks (exclusive with --mesh-data/--mesh-vocab)")
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--hidden-size", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    seq = args.mesh_seq > 1
    if args.mesh_data is None:
        args.mesh_data = 1 if seq else 2
    if args.mesh_vocab is None:
        args.mesh_vocab = 1 if seq else 4
    check_mesh_flags(args.mesh_seq, args.mesh_data, args.mesh_vocab, Config.num_steps)
    need = args.mesh_seq * args.mesh_data * args.mesh_vocab
    if args.num_processes != need:
        raise SystemExit(
            f"mesh data {args.mesh_data} x vocab {args.mesh_vocab} x seq {args.mesh_seq} "
            f"needs {need} processes, the launch has {args.num_processes}: aborting")
    if not 0 <= args.process_id < args.num_processes:
        raise SystemExit(f"--process-id {args.process_id} is outside "
                         f"[0, {args.num_processes})")

    device = rank_device(resolve_device(args.device), args.process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    multihost_init(f"tcp://{args.coordinator}", args.num_processes, args.process_id, device)
    try:
        _train(args, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, device):
    vocab, train, dev, _ = load_dataset(args.data)
    config = Config(
        vocab_size=pad_vocab_size(len(vocab), args.mesh_vocab),
        num_layers=args.num_layers,
        hidden_size=args.hidden_size,
        mesh_data=args.mesh_data,
        mesh_vocab=args.mesh_vocab,
        mesh_seq=args.mesh_seq,
        epochs=args.epochs,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        grad_accum_steps=args.grad_accum,
    )
    train_lm(config, train, dev, exp_dir=args.exp, resume=args.resume,
             mesh=rank_mesh(config, device), device=device)


if __name__ == "__main__":
    main()
