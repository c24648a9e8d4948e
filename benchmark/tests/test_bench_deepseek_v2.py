"""The ``deepseek_v2`` family's arithmetic, by hand-computed cases: its
leaves (8.10 B parameters in the 14-layer cut), its useful operations, the
two new metrics' ``work``, the head as ``project_lse_roofline.serve``
reads it; the configuration file beside the published keys; the cell at a
test's size on the CPU."""

import ast
import collections
import math
import os
import types

import pytest

from benchmark.core import registry
from benchmark.core.peaks import PEAK
from benchmark.tests.conftest import run_tiny, tiny_cell

FAMILY = registry.family("deepseek_v2")
CFG = registry.config("deepseek-v2-lite-14l")
MODEL = CFG["model"]
CELL = "serve.dsv2lite.realistic.s256"
METRICS = registry.metrics()


def test_the_leaves_hold_8_10_billion_parameters_and_only_the_head_is_int8():
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048 + 2048 + 512 + 2048
    dense = 3 * 2048 * 10944
    moe = 2048 * 64 + 64 * 3 * 2048 * 1408 + 3 * 2048 * 2816
    want = 2 * 102400 * 2048 + 14 * attn + dense + 13 * moe + 2048
    assert want == 8_103_461_888
    leaves = FAMILY.leaves(MODEL)
    assert sum(math.prod(lf.shape) for lf in leaves) == want
    assert [(lf.name, lf.int8_axis) for lf in leaves if lf.int8_axis is not None] == [
        ("head/W", 0)]
    assert set(lf.scale for lf in leaves) == set(CFG["weights"])
    assert FAMILY.head_blocks(MODEL) == [(2048, 102400)]


def test_serve_ops_of_a_two_kana_sentence():
    """Three positions of 10 rows; ancestors 1, 2, 2; per row and layer the
    projections (27,525,120), the attention (10,240 an ancestor), the dense
    MLP (134,479,872) or 6 routed + 2 shared experts (138,412,032) and the
    fp32 router (262,144); the int8 head; 6 candidate columns of 4,096."""
    by_reading = {"あ": [2], "い": [3], "あい": [4]}
    got = FAMILY.serve_ops(["あい"], MODEL, CFG["serve"], by_reading, 5)
    per_row = [14 * (27_525_120 + 10_240 * a) + 134_479_872 + 13 * 138_412_032
               for a in (1, 2, 2)]
    assert got == {"bf16": float(10 * sum(per_row) + 10 * 6 * 2 * 2048),
                   "fp32": float(3 * 10 * 13 * 262_144),
                   "int8": float(3 * 10 * 2 * 2048 * 102400)}


def test_moe_roofline_work_at_2560_rows():
    work = METRICS["moe_roofline.serve"].work
    assert work(2560, 2048, 64, 6, 1408, 2816) == (
        2048 * 64 * 4 + 3 * 2048 * 2816 * 2 + 2 * 2560 * 2048 * 2,
        6 * 2048 * (2560 * 6 * 1408 + 2560 * 2816), 2 * 2560 * 2048 * 64)
    assert work(2560, 2048, 64, 6, 1408, 2816)[:2] == (56_098_816, 354_334_801_920)


def test_mla_attention_roofline_work_at_frame_7():
    """Frame 7 with words of at most 5 kana: no path is shorter than 2 words
    after the root, so 3 ancestors a row."""
    mod = METRICS["mla_attention_roofline.serve"]
    assert [mod.ancestors(p, 5) for p in (0, 1, 5, 6, 7, 10, 11)] == [1, 2, 2, 3, 3, 3, 4]
    nbytes, ops = mod.work(2560, 7, 5, 2048, 16, 128, 64, 128, 512)
    assert nbytes == 2 * 13_763_072 + 2 * 2560 * 2048 * 2 + 2560 * 3 * 576 * 2 == 57_345_024
    assert ops == 2560 * (27_525_120 + 2 * 3 * 16 * 320) == 70_542_950_400


def _trace(by_range, calls):
    device = types.SimpleNamespace(device_s_by_range=by_range)
    peaks = dict(PEAK, exp=16 * 132 * 1980e6)
    return types.SimpleNamespace(kind="serve", device=device, calls=calls, peaks=peaks,
                                 head_blocks=FAMILY.head_blocks(MODEL))


def test_the_head_reads_as_int8_2048_by_102400_and_the_new_metrics_read_their_ranges():
    t = _trace({"project_lse": 1e-3, "moe": 1e-3, "mla_attention": 1e-3},
               {"project_lse": collections.Counter({2560: 1}),
                "moe": collections.Counter({(2560, 2048, 64, 6, 1408, 2816): 1}),
                "mla_attention": collections.Counter(
                    {(2560, 7, 5, 2048, 16, 128, 64, 128, 512): 1})})
    # 2 x 2,560 x 2,048 x 102,400 int8 operations bound it
    assert METRICS["project_lse_roofline.serve"].read(t) == pytest.approx(
        2 * 2560 * 2048 * 102400 / 1979e12 / 1e-3 * 100)
    assert METRICS["moe_roofline.serve"].read(t) == pytest.approx(
        (354_334_801_920 / 989e12 + 671_088_640 / 67e12) / 1e-3 * 100)
    assert METRICS["mla_attention_roofline.serve"].read(t) == pytest.approx(
        70_542_950_400 / 989e12 / 1e-3 * 100)
    # a program without the sublayers (the parent's): nothing to read
    empty = _trace({"project_lse": 1e-3}, {"project_lse": collections.Counter({2560: 1})})
    assert METRICS["moe_roofline.serve"].read(empty) is None
    assert METRICS["mla_attention_roofline.serve"].read(empty) is None


def test_the_configuration_keeps_the_published_keys():
    top = {k: v for k, v in CFG.items() if k in MODEL}
    assert top == MODEL
    assert CFG["reduced"] == ["num_hidden_layers"] and CFG["published"] == {
        "num_hidden_layers": 27}
    assert (MODEL["num_hidden_layers"], MODEL["first_k_dense_replace"]) == (14, 1)


def test_the_reference_imports_neither_jax_nor_the_program():
    for part in ("reference", "families"):
        path = os.path.join(registry.BENCH, part, "deepseek_v2.py")
        for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "jlm_tpu")
                assert part == "families" or name.split(".")[0] != "jlm_tpu_torch"


TINY = dict(MODEL, vocab_size=400, hidden_size=64, num_hidden_layers=2, intermediate_size=96,
            moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1,
            num_experts_per_tok=2, num_attention_heads=4, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16)
TINY_SCALES = {"embed": 1.0, "norm": 1.0, "q_proj": 3 / 8, "kv_a_proj": 3 / 8,
               "kv_b_proj": 3 / math.sqrt(32), "o_proj": 1.732 / 8, "mlp_in": 3 / 8,
               "dense_down": 1.732 / (0.6 * math.sqrt(96)),
               "expert_down": 1.732 / (0.6 * math.sqrt(32)),
               "shared_down": 1.732 / (0.6 * math.sqrt(32)), "router": 0.5, "head_W": 0.8}


def test_the_cell_runs_at_a_tests_size():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell, cfg, kind = tiny_cell(CELL, TINY)
        cfg["weights"] = TINY_SCALES
        out = run_tiny(cell, cfg, kind)
    finally:
        torch.set_num_threads(threads)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {k: c["value"] for k, c in out["checks"].items() if k in ("missing",
                                                                     "invalid_paths")} == {
        "missing": 0.0, "invalid_paths": 0.0}
    assert set(out["metrics"]) == {"chars_per_s", "job_p80_ms", "setup_s"}
