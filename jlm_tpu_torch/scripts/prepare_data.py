"""Corpus prep CLI (counterpart of ``scripts/prepare_data.py``).

Reads a ``display/reading/POS``-token corpus (or generates the synthetic
one), builds the frequency vocab, encodes, splits, and writes the data dir
(the reference's layout, which both packages' ``load_dataset`` read).

  python -m jlm_tpu_torch.scripts.prepare_data --out data/ --vocab-size 50000 \\
      [--corpus corpus.txt [--stream] | --synthetic-sentences 50000]

``--stream`` is the constant-memory path (:mod:`jlm_tpu_torch.data.streaming`):
the native C++ chunk encoder, a memory-mapped ``corpus.bin``; the ids are
those of the in-memory path.
"""

import argparse

from jlm_tpu_torch.data import build_vocab, encode_corpus, generate_corpus, split_corpus
from jlm_tpu_torch.data.io import save_dataset


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m jlm_tpu_torch.scripts.prepare_data")
    ap.add_argument("--out", required=True)
    ap.add_argument("--corpus", default=None, help="corpus file, one sentence/line")
    ap.add_argument("--synthetic-sentences", type=int, default=50_000)
    ap.add_argument("--synthetic-seed", type=int, default=1234)
    ap.add_argument("--vocab-size", type=int, default=50_000)
    ap.add_argument("--dev-frac", type=float, default=0.05)
    ap.add_argument("--test-frac", type=float, default=0.05)
    ap.add_argument("--stream", action="store_true",
                    help="constant-memory prep: native C++ chunk encoder, "
                         "memory-mapped corpus.bin output (for corpora that "
                         "don't fit in RAM)")
    args = ap.parse_args(argv)

    if args.stream:
        if not args.corpus:
            ap.error("--stream requires --corpus (a file to stream)")
        from jlm_tpu_torch.data.streaming import save_dataset_streamed

        vocab, n = save_dataset_streamed(
            args.out, args.corpus, args.vocab_size,
            args.dev_frac, args.test_frac,
        )
        print(f"wrote {args.out} (streamed): vocab={len(vocab)} ids={n}")
        return

    if args.corpus:
        with open(args.corpus) as f:
            lines = [l.rstrip("\n") for l in f]
    else:
        lines = generate_corpus(args.synthetic_sentences, args.synthetic_seed)
    vocab = build_vocab(lines, args.vocab_size)
    ids = encode_corpus(lines, vocab)
    train, dev, test = split_corpus(ids, args.dev_frac, args.test_frac)
    save_dataset(args.out, vocab, train, dev, test)
    print(
        f"wrote {args.out}: vocab={len(vocab)} train={len(train)} "
        f"dev={len(dev)} test={len(test)}"
    )


if __name__ == "__main__":
    main()
