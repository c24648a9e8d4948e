"""Experiment configuration.

The port's copy of :mod:`jlm_tpu.config`: the same fields and the same
``config.json``, so experiment directories cross-load between packages.
The field comments are the reference's.

TPU-native analogue of the reference's cross-cutting config module
(ref: JLM:config.py — hyperparams, paths, softmax-variant flags; see
SURVEY.md §3.1).  One frozen dataclass covers model dims, output-head
variant, quantization, decoding, training, and mesh shape; the five
BASELINE.json benchmark configs are expressed as presets.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

# Special token ids.  Vocab ids are frequency-ordered AFTER the specials
# (ref: SURVEY.md §4.1 — frequency order is load-bearing for D-softmax
# block membership; specials sit at the front and are high-frequency anyway).
EOS_ID = 0
UNK_ID = 1
NUM_SPECIALS = 2
EOS_TOKEN = "<eos>"
UNK_TOKEN = "<unk>"


@dataclasses.dataclass(frozen=True)
class DSoftmaxConfig:
    """Differentiated-softmax output-head segmentation (SURVEY.md §4.4).

    The vocabulary (frequency-ordered) is split into ``len(block_sizes)``
    blocks; block k has ``block_sizes[k]`` words projected from
    ``block_dims[k]`` hidden dims.  ``mode``:

    - ``"prefix"``  — D-softmax*: every block projects from the *prefix*
      slice ``h[:d_k]`` of the hidden state (the reference's variant).
    - ``"disjoint"``— original D-softmax: block k projects from its own
      disjoint segment of ``h``.

    Both rules are kept behind this flag because the reference's exact rule
    is [C-med] in SURVEY.md §4.4.
    """

    block_sizes: Tuple[int, ...]
    block_dims: Tuple[int, ...]
    mode: str = "prefix"  # "prefix" (D-softmax*) | "disjoint" (D-softmax)

    def __post_init__(self):
        assert len(self.block_sizes) == len(self.block_dims)
        assert self.mode in ("prefix", "disjoint")
        if self.mode == "disjoint":
            # Disjoint segments must fit in the hidden vector end to end.
            pass


@dataclasses.dataclass(frozen=True)
class Config:
    # --- model (SURVEY.md §4.2) ---
    vocab_size: int = 50_000
    embed_size: int = 256
    hidden_size: int = 512
    num_layers: int = 1
    forget_bias: float = 1.0  # standard LSTM forget-gate bias init offset

    # --- output head ---
    head: str = "full"  # "full" | "dsoftmax"
    dsoftmax: Optional[DSoftmaxConfig] = None

    # --- quantization (SURVEY.md §4.3) ---
    quantize: bool = False  # int8 symmetric per-column weights + fp32 scale
    # Native int8 MXU decode head: int8 weights feed the systolic array
    # directly (int8xint8 -> int32 at 2x the bf16 rate on v5e) with per-row
    # activation quantization in-kernel.  Scores gain ~1e-2-scale activation
    # quantization error vs the exact dequant path (bound pinned by
    # tests/test_kernels.py::test_int8_mxu_score_error_bound; beam-10 path
    # identity asserted at 50 sentences in bench.py).  DEFAULT since round
    # 4 — it is the measured-best head in-engine (r3: 50.1k vs 46.6k
    # chars/s dequant) — and a no-op unless int8-quantized weights are
    # loaded; set False to force the exact dequant head for parity work.
    int8_mxu: bool = True

    # --- decoding (SURVEY.md §4.5-4.7) ---
    beam_width: int = 10
    n_best_max: int = 4  # how many beams the device walks back per sentence
    max_word_len: int = 5       # max reading length considered in the lattice
    max_kana_len: int = 62      # T_max: static frame count for the device scan
    max_nodes_per_frame: int = 16   # N_max: padded nodes ending at a position
    max_lookahead: int = 64     # C_max: padded candidate words starting at a position
    # Beam-prune top-k implementation: "argmax" = k unrolled argmax+mask
    # passes (identical tie semantics to lax.top_k, far cheaper than the
    # sort-based TopK XLA emits at [S, 640]→10 — VERDICT r4 weak #1);
    # "sort" = plain lax.top_k (r1–r4 path, kept for A/B).
    topk_mode: str = "argmax"
    # Frame-count bucket granularity: a batch scans
    # round_up(max_len, t_bucket_multiple) frames (min 4).  Device time is
    # LINEAR in scanned frames, so finer buckets are a direct throughput
    # win (measured on the bench stream: mult 4 → 1 cuts frames/rep
    # 10.67 → 9.67, +9%); the cost is more distinct compiled programs
    # (≤ max_kana_len per batch-size bucket, amortized by the persistent
    # compile cache).  Raise to 4 to bound compile count on cold caches.
    t_bucket_multiple: int = 1
    # Decode-scan unroll factor (jax.lax.scan unroll=): >1 lets XLA fuse
    # glue ops across adjacent frames (fewer loop-boundary layout breaks).
    # Measured round 5 (one v5e, S=512 int8-MXU engine, interleaved
    # A/Bs; path identity exact in every variant): with the onehot
    # selection structure, unroll 1/2/4 = 84.9/86.1/89.6k chars/s in one
    # window — 4 is the sweet spot (typical chunks scan 8-14 frames).
    scan_unroll: int = 4
    # Survivor-state gather implementation: "take" = take_along_axis
    # (XLA dynamic-gather); "onehot" = 0/1-matrix einsum on the MXU
    # (selection by matmul is exact; TPU gathers serialize on sublanes).
    # onehot measured +6% end-to-end on its own (see scan_unroll note).
    gather_mode: str = "onehot"
    # Policy when a frame has more nodes than max_nodes_per_frame.  The
    # reference's lattices are uncapped Python lists (SURVEY.md §4.5), so a
    # silent drop is a top-1 parity hazard against dense homophone frames:
    # "warn" (default) emits a warning with the drop count, "raise" errors,
    # "ignore" truncates silently (round-1 behavior).
    node_overflow: str = "warn"  # "warn" | "raise" | "ignore"

    # --- training (SURVEY.md §4.8) ---
    batch_size: int = 32
    num_steps: int = 32         # truncated-BPTT window
    optimizer: str = "adam"     # "adam" | "sgd"
    learning_rate: float = 1e-3
    lr_decay: float = 0.8       # multiplicative decay per epoch after decay_start
    lr_decay_start_epoch: int = 4
    # >0: PPL-GATED decay — hold full lr until dev PPL first drops below
    # this gate, then decay from the next epoch (overrides the epoch
    # rule).  Tasks with a long initial plateau (the topic-conditioned
    # corpus sits at unigram PPL ~59 for a seed-dependent number of
    # epochs) are seed-lotteries under fixed early decay: late escapers
    # anneal before learning anything (measured round 5).
    lr_decay_gate_ppl: float = 0.0
    max_grad_norm: float = 5.0
    epochs: int = 8
    sampled_softmax_samples: int = 0  # >0 => sampled-softmax training loss
    use_pallas_scan: bool = False  # fused Pallas time-block LSTM scan in training
    # Fused softmax-CE training loss (ops/softmax_ce.py): logits never
    # materialize in HBM ([B*T, V] is 400-800 MB/step at flagship dims).
    # Full head, fp weights only; exact grads via custom VJP.
    fused_ce: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # "bfloat16" => mixed-precision forward
    grad_accum_steps: int = 1  # microbatches accumulated per optimizer update
    remat: bool = False  # jax.checkpoint the LSTM cell (HBM-for-FLOPs trade)

    # --- parallelism (SURVEY.md §3.3) ---
    mesh_data: int = 1    # data-parallel axis size (independent lattices/batches)
    mesh_vocab: int = 1   # vocab (tensor) parallel axis size
    mesh_seq: int = 1     # sequence/time-block pipeline axis size
    seq_microbatches: int = 0  # pipeline streams (0 = auto: ~2x mesh_seq)

    # --- misc ---
    seed: int = 0

    @property
    def beam_pad(self) -> int:
        """Beam width padded to an even row count.

        The beam axis always appears FLATTENED with the sentence axis in
        device compute (``S·B`` matmul rows), so it does not itself need
        the 8-sublane alignment — rounding 10 up to 16 (round 1/2
        behavior) made every row-proportional cost in the frame step 60%
        more expensive for beam_width=10.  Even keeps ``S·B`` a multiple
        of 8 for any bucketed S >= 4.

        SHAPE-BREAK NOTE (round 3): changing this rule changes every
        beam-row cache/payload shape.  Incremental-session snapshots
        record ``beam_pad`` and refuse to resume under a different value
        (``IncrementalDecoder.load_session``); any other serialized
        ``[.., beam_pad, ..]`` state from an older build must be
        re-generated.
        """
        return max(8, self.beam_width + (self.beam_width % 2))

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        if d.get("dsoftmax"):
            ds = d["dsoftmax"]
            d["dsoftmax"] = DSoftmaxConfig(
                block_sizes=tuple(ds["block_sizes"]),
                block_dims=tuple(ds["block_dims"]),
                mode=ds["mode"],
            )
        return Config(**d)


def pad_vocab_size(vocab_size: int, mesh_vocab: int = 1) -> int:
    """Round the model vocab up so every vocab shard is equal-sized.

    Padded ids are dead classes (never targets, never lattice candidates);
    training pushes their logits down like any unused word's.
    """
    mult = max(1, mesh_vocab)
    return -(-vocab_size // mult) * mult


def default_dsoftmax_blocks(
    vocab_size: int, hidden_size: int, multiple: int = 1
) -> DSoftmaxConfig:
    """Frequency-tiered default split, Chen et al.-style (SURVEY.md §4.4).

    ~16% of the vocab (most frequent) gets the full hidden dim, the next
    ~34% gets half, the rarest ~50% a quarter — e.g. 100k → [16k@H,
    34k@H/2, 50k@H/4].  Dims are kept multiples of 128 for MXU tiling.
    ``multiple`` rounds each block size so it divides evenly over a
    ``mesh_vocab``-way column sharding (vocab_size must itself divide).
    """

    # MXU-friendly 128-lane alignment at flagship dims; clamp to H so small
    # (test-scale) hidden sizes still get a valid prefix slice.
    unit = 128 if hidden_size >= 256 else 8
    def align(d):
        return min(hidden_size, max(unit, (d // unit) * unit))

    def round_to(b):
        return max(multiple, (b // multiple) * multiple)

    assert vocab_size % max(1, multiple) == 0, (
        f"vocab_size {vocab_size} must divide by multiple={multiple}; "
        "pad it with pad_vocab_size() first"
    )
    b0 = round_to(int(vocab_size * 0.16))
    b1 = round_to(int(vocab_size * 0.34))
    b2 = vocab_size - b0 - b1
    return DSoftmaxConfig(
        block_sizes=(b0, b1, b2),
        block_dims=(hidden_size, align(hidden_size // 2), align(hidden_size // 4)),
        mode="prefix",
    )


# ---------------------------------------------------------------------------
# BASELINE.json benchmark presets (verbatim configs 1-5; SURVEY.md §8)
# ---------------------------------------------------------------------------

def baseline_config(n: int, vocab_size: int = 50_000) -> Config:
    """Return preset ``n`` in 1..5 from BASELINE.json's ``configs`` list."""
    base = Config(vocab_size=vocab_size)
    if n == 1:
        # CPU ref: 1-layer 512-hidden, 50k lexicon, full softmax, greedy Viterbi.
        return base.replace(num_layers=1, hidden_size=512, head="full", beam_width=1)
    if n == 2:
        # beam width-10 lattice decoding, per-step top-k pruning, full softmax.
        return base.replace(beam_width=10, head="full")
    if n == 3:
        # D-softmax head, vocab sharded across chips with all-gather top-k.
        return base.replace(
            beam_width=10,
            head="dsoftmax",
            dsoftmax=default_dsoftmax_blocks(vocab_size, 512),
            mesh_vocab=4,
        )
    if n == 4:
        # int8 weights, in-kernel dequant, incremental per-keystroke updates.
        return base.replace(beam_width=10, quantize=True)
    if n == 5:
        # 2-layer, 100k vocab, streaming batched conversion over multi-host mesh.
        v = 100_000
        return Config(
            vocab_size=v,
            num_layers=2,
            hidden_size=512,
            head="dsoftmax",
            dsoftmax=default_dsoftmax_blocks(v, 512),
            beam_width=10,
            mesh_data=2,
            mesh_vocab=4,
        )
    raise ValueError(f"baseline config must be 1..5, got {n}")
