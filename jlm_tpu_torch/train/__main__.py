"""Training CLI of the port: ``scripts/train.py``'s flags.

  python -m jlm_tpu_torch.train --data data/ --exp exp/h512-v50k \\
      --fused-ce [--pallas-scan] [--bf16] [--dsoftmax] [--sampled-softmax 1024] \\
      [--grad-accum 4] [--remat] [--resume] [--mesh-data 2 --mesh-vocab 4 |
      --mesh-seq 4 [--seq-microbatches 8]] [--device cuda]

``--pallas-scan`` runs the LSTM through the fused scan kernels on a CUDA
device (their plain versions with ``--device cpu``).  ``--mesh-data`` /
``--mesh-vocab`` spawn one process per rank of the ``(data, vocab)`` mesh
(``parallel.comm.spawn``): rank r on ``cuda:(r % device_count)``, or on
the CPU with ``--device cpu``, over the backend ``parallel.mesh.backend_for``
picks (``gloo`` on the CPU and where ranks share a GPU, else ``nccl``).
The model vocab pads to a multiple of ``--mesh-vocab``.  ``--mesh-seq P``
(exclusive with both) spawns P ranks of the time-block pipeline: the BPTT
window's time axis cut into P blocks, ``--seq-microbatches`` pipeline
streams a step (default ``max(P, min(batch, 2P))``); ``--num-steps``
must divide by P.
"""

import argparse

from jlm_tpu_torch.config import Config, default_dsoftmax_blocks, pad_vocab_size
from jlm_tpu_torch.data.io import load_dataset
from jlm_tpu_torch.parallel.train_step import check_mesh_flags
from jlm_tpu_torch.train.trainer import train_lm, train_rank


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m jlm_tpu_torch.train")
    ap.add_argument("--data", required=True)
    ap.add_argument("--exp", required=True, help="experiment output dir")
    ap.add_argument("--embed-size", type=int, default=256)
    ap.add_argument("--hidden-size", type=int, default=512)
    ap.add_argument("--num-layers", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-steps", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr-decay", type=float, default=0.8)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--sampled-softmax", type=int, default=0)
    ap.add_argument("--dsoftmax", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel ranks (batch rows split over them)")
    ap.add_argument("--mesh-vocab", type=int, default=1,
                    help="vocab-parallel ranks (the output head's columns split over them)")
    ap.add_argument("--mesh-seq", type=int, default=1,
                    help="time-block pipeline ranks (the BPTT window's time axis split over "
                         "them; exclusive with --mesh-data/--mesh-vocab)")
    ap.add_argument("--seq-microbatches", type=int, default=0,
                    help="pipeline streams per step (0 = auto ~2x mesh-seq)")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 forward/backward with fp32 master params")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches accumulated per optimizer update")
    ap.add_argument("--fused-ce", action="store_true",
                    help="fused softmax-CE kernels: logits never in device memory")
    ap.add_argument("--pallas-scan", action="store_true",
                    help="fused time-block LSTM scan kernels (the flag keeps the "
                         "reference's name)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute LSTM activations in the backward")
    ap.add_argument("--model-vocab", type=int, default=0,
                    help="force the model's vocab size above the data vocab")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --exp")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap.parse_args(argv)


def _config(args, n_words: int) -> Config:
    v_model = pad_vocab_size(max(n_words, args.model_vocab), args.mesh_vocab)
    return Config(
        vocab_size=v_model,
        embed_size=args.embed_size,
        hidden_size=args.hidden_size,
        num_layers=args.num_layers,
        batch_size=args.batch_size,
        num_steps=args.num_steps,
        epochs=args.epochs,
        optimizer=args.optimizer,
        learning_rate=args.lr,
        lr_decay=args.lr_decay,
        sampled_softmax_samples=args.sampled_softmax,
        head="dsoftmax" if args.dsoftmax else "full",
        dsoftmax=(default_dsoftmax_blocks(v_model, args.hidden_size, multiple=args.mesh_vocab)
                  if args.dsoftmax else None),
        seed=args.seed,
        mesh_data=args.mesh_data,
        mesh_vocab=args.mesh_vocab,
        mesh_seq=args.mesh_seq,
        seq_microbatches=args.seq_microbatches,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        grad_accum_steps=args.grad_accum,
        fused_ce=args.fused_ce,
        remat=args.remat,
        use_pallas_scan=args.pallas_scan,
    )


def main(argv=None):
    args = parse_args(argv)
    check_mesh_flags(args.mesh_seq, args.mesh_data, args.mesh_vocab, args.num_steps)
    vocab, train, dev, _ = load_dataset(args.data)
    cfg = _config(args, len(vocab))
    world = cfg.mesh_seq * cfg.mesh_data * cfg.mesh_vocab
    if world > 1:
        from jlm_tpu_torch.parallel.comm import spawn

        spawn(train_rank, world, device=args.device,
              args=(cfg, args.data, args.exp, args.resume))
        return
    train_lm(cfg, train, dev, exp_dir=args.exp, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
