"""Model families (``families/<family>.py``): the LSTM family pinned to what
the harness gave before the LSTM moved into its family module, and a second
family joining the benchmark by new files alone."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.core import registry
from benchmark.core.weights import dequantize_params, flatten, make_weights, quantize_params
from benchmark.data.lexicon import realistic_lexicon, realistic_sentences, synthetic_lexicon
from benchmark.data.synthetic import generate_test_set
from benchmark.reference.beam import beam_search
from benchmark.reference.lstm import reference_steps
from benchmark.tests.conftest import TINY_DSOFTMAX, TINY_MODEL, tiny_cell

BENCH = registry.BENCH
LSTM = registry.family("lstm")
CPU = torch.device("cpu")
SEED = 2**31 + 11
SCALES = registry.config("jlm-50k-1l")["weights"]
MODELS = {"full": TINY_MODEL, "dsoftmax": TINY_DSOFTMAX}

# Every expected value below was computed on the CPU with the harness as it
# stood before the LSTM moved into families/lstm.py (core/weights.py's own
# leaf table, core/serve.py's and core/train.py's useful_ops, reference/lm.py
# and a beam search that stored (c, h) by position), and is hard-coded here:
# it is never recomputed from the code it pins.
DIGESTS = {
    "full": {
        "weights": "ef31ab622f9c3bf7f97e65cfbdc2854991897251b28af8d3fd54db1a61161c0a",
        "int8": "179c0849e51c3f32907839063fb71235ba1c72c78f782bd255c76565e084223b",
        "int8.dequantized": "e2b15ab5818354f410729608fad4c1bfee50c48db6ddd2758bef62c70f9da2b7",
        "int4": "538b624df19add35761280e3f50d7c929f7d73146cb71eb13f5090a14efeff30",
        "int4.dequantized": "14ca6a7caf2b6e721a26e2537780e35fb59b5a1ceb3c12f82da7e3ef946d8d29",
        "beam": "47b10ff59810ded37e76ca4848a3cdc72559c4c271d1891ebd1811910ed39d76",
    },
    "dsoftmax": {
        "weights": "38c71b807033026f5f33e4d9d761ad2b7180b866e363733fac537faf6ed201d8",
        "int8": "ff05e370f60a9b20b25afe4b249d93f76d3ed63fd7d9262bda54f8d2462a4af3",
        "int8.dequantized": "276f42820ed793aaca6ea6a6da2d2fd5afecba81d62805d439f31b9fe64be141",
        "int4": "83ef30dfe1aab1e046f9ae49ec2487c526f5d02d77d87732c0f9c16ead0b84b8",
        "int4.dequantized": "eca2a3b5f8c0df997ee4d1b4e100bbd1d7bfe0f67190daae55d722e2ba429350",
        "beam": "691fe415a283077ff7d34f365a7814813549b79f9fed9e68224677b9664ca760",
    },
}
BEAM_SCORES = {
    "full": [-34.86328172683716, -29.31722354888916, -41.8914270401001, -29.625638484954834,
             -29.791226863861084, -30.36823272705078, -48.0045371055603, -29.660008907318115,
             -29.184785842895508, -35.99652147293091, -41.004695892333984, -41.87828731536865,
             -46.09428548812866, -28.368173599243164, -29.930676460266113, -30.223944187164307,
             -48.99683618545532, -47.75241661071777, -29.674654006958008, -48.009750843048096,
             -30.001616954803467, -29.02012300491333, -30.38619899749756, -41.46313810348511],
    "dsoftmax": [-34.68579292297363, -28.54339361190796, -41.155442237854004,
                 -30.026473999023438, -29.645047664642334, -28.814414978027344,
                 -48.495200634002686, -29.37446689605713, -30.678288459777832,
                 -35.27397394180298, -42.166616916656494, -41.21063947677612,
                 -48.220595836639404, -29.724204540252686, -29.080646991729736,
                 -29.65614414215088, -48.618242263793945, -47.43446922302246,
                 -29.272852897644043, -49.02437448501587, -30.390339374542236,
                 -29.57976722717285, -30.110446453094482, -42.10541009902954],
}
# (synthetic job, realistic job) of 24 sentences each, and 20 training steps
SERVE_OPS = {
    "jlm-50k-1l": ({"bf16": 8280135680.0, "int8": 134656000000.0},
                   {"bf16": 12875601920.0, "int8": 209408000000.0}),
    "jlm-100k-2l-dsoftmax": ({"bf16": 19311155200.0, "int8": 122536960000.0},
                             {"bf16": 30030305280.0, "int8": 190561280000.0}),
}
TRAIN_OPS = {"jlm-50k-1l": {"fp32": 1546188226560.0, "bf16": 25165824000000.0},
             "jlm-100k-2l-dsoftmax": {"fp32": 3607772528640.0, "bf16": 50331648000000.0}}
LOSSES = [6.016355037689209, 6.09861421585083, 6.007079601287842]
CONTROL_SERVE = {"missing": 0.0, "invalid_paths": 0.0, "score_gap": 0.7283267974853516,
                 "path_gap": 0.15000247955322266}
CONTROL_TRAIN = {"control": {"loss_gap": 0.0007307177826327998,
                             "grad_gap": 0.000512508529356788,
                             "update_gap": 0.0005472641460712943},
                 "half_batch": {"loss_gap": 0.06886435388831366,
                                "grad_gap": 0.1866475977642281,
                                "update_gap": 0.26346935983188613}}


def digest(tree) -> str:
    h = hashlib.sha256()
    for name, t in flatten(tree).items():
        for part in (t.values() if isinstance(t, dict) else [t]):
            h.update(name.encode())
            h.update(str(part.dtype).encode())
            h.update(part.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("tag", list(MODELS))
def test_the_lstm_weights_and_int8_leaves_are_the_same_bits(tag):
    leaves = LSTM.leaves(MODELS[tag])
    w = make_weights(leaves, SCALES, SEED, CPU)
    got = {"weights": digest(w)}
    for bits in (8, 4):
        q = quantize_params(w, leaves, bits)
        got[f"int{bits}"] = digest(q)
        got[f"int{bits}.dequantized"] = digest(dequantize_params(q, leaves))
    assert got == {k: v for k, v in DIGESTS[tag].items() if k != "beam"}


@pytest.mark.parametrize("tag", list(MODELS))
def test_the_lstm_reference_beam_search_finds_the_same_paths_and_scores(tag):
    model = MODELS[tag]
    leaves = LSTM.leaves(model)
    w = make_weights(leaves, SCALES, SEED, CPU)
    lm = LSTM.reference_lm(dequantize_params(quantize_params(w, leaves), leaves), model)
    kanas = [k for k, _ in generate_test_set(24, seed=3)]
    ref = beam_search(lm, kanas, synthetic_lexicon(model["vocab_size"]), 6, 5, 16, CPU)
    assert [s for s, _ in ref] == BEAM_SCORES[tag]
    got = [[s, [w for w, _ in nodes], [st for _, st in nodes]] for s, nodes in ref]
    assert hashlib.sha256(json.dumps(got).encode()).hexdigest() == DIGESTS[tag]["beam"]


def test_the_lstm_useful_ops_are_the_same():
    synthetic = [k for k, _ in generate_test_set(24, seed=5)]
    syn = synthetic_lexicon(50000)
    rl = realistic_lexicon(3000, seed=7)
    realistic = realistic_sentences(rl, 24, seed=5)
    tp = registry.workload("train.jlm50k.b256x32")["traffic"]
    for name, (want_syn, want_real) in SERVE_OPS.items():
        cfg = registry.config(name)
        model, serve = cfg["model"], cfg["serve"]
        assert LSTM.serve_ops(synthetic, model, serve, syn.by_reading(), 5) == want_syn
        assert LSTM.serve_ops(realistic, model, serve, rl.by_reading(), 5) == want_real
        assert LSTM.train_ops(model, tp, 20) == TRAIN_OPS[name]


def test_the_lstm_reference_steps_give_the_same_losses():
    cell, cfg, kind = tiny_cell("train.jlm50k.b256x32")
    tp = cell["traffic"]
    w = make_weights(LSTM.leaves(TINY_MODEL), SCALES, SEED, CPU)
    ids = kind.build(tp, TINY_MODEL, SEED).ids(-1, 3)
    assert reference_steps(flatten(w), TINY_MODEL, cfg["train"], ids, tp, CPU)["losses"] == LOSSES


def test_the_controls_read_the_same():
    """calibrate.py's control and planted fault at the control test's size.
    The gradient's and the change's readings move with the CPU's thread
    count in their last digits, the losses do not."""
    from benchmark import calibrate
    from benchmark.tests.test_bench_faults import CONTROL_MODEL, SERVE, TRAIN

    cell, cfg, kind = tiny_cell(SERVE, CONTROL_MODEL)
    got = calibrate.control_serve(cell, cfg, kind, 2001, CPU)
    assert {k: c["value"] for k, c in got.items()} == CONTROL_SERVE
    cell, cfg, kind = tiny_cell(TRAIN, CONTROL_MODEL)
    got = calibrate.control_train(cell, cfg, kind, 2001, CPU)
    for name, want in CONTROL_TRAIN.items():
        assert got[name]["loss_gap"] == want["loss_gap"]
        assert got[name] == pytest.approx(want, rel=1e-4)


# -- a second family, by new files alone: a bag-of-words LM whose state is the
# path's word ids (a row's width grows with its position), which no program
# serves; it goes through the registry, the weights, the int8 round trip, the
# useful operations and the reference beam search with the output check

STUB_FAMILY = '''"""Model family ``bow``: a bag-of-words LM that no program serves."""

from benchmark.core.weights import Leaf
from benchmark.reference.bow import BowLM


def head_blocks(model):
    return [(model["embed_size"], model["vocab_size"])]


def leaves(model):
    V, E = model["vocab_size"], model["embed_size"]
    return [Leaf("embedding", (V, E), "embedding", 1), Leaf("out/W", (E, V), "head_W", 0),
            Leaf("out/b", (V,), "head_b", None)]


def _no_program(*args, **kwargs):
    raise NotImplementedError("no program serves the bag-of-words LM")


make_config = make_decoder = make_trainer = flat_params = first_moments = _no_program
serve_patch_points = train_patch_points = _no_program
reference_steps = train_controls = train_ops = None


def reference_lm(params, model):
    return BowLM(params)


def control_lm(weights, model):
    from benchmark.core.weights import dequantize_params, quantize_params

    lv = leaves(model)
    return BowLM(dequantize_params(quantize_params(weights, lv, 4), lv))


def serve_ops(kanas, model, serve, by_reading, max_word_len):
    rows = sum(len(k) + 1 for k in kanas) * serve["beam_width"]
    return {"bf16": float(rows * 2 * model["embed_size"] * model["vocab_size"])}
'''

STUB_REFERENCE = '''"""The bag-of-words LM: log_softmax(mean of the path's embeddings W + b)."""

import torch


class BowLM:
    """The state: the path's word ids [rows, n], -1 past a shorter path."""

    def __init__(self, params):
        self.p = params

    def initial_state(self, rows, device):
        return torch.full((rows, 0), -1, dtype=torch.long, device=device)

    def step(self, words, state):
        ids = torch.cat([state, words[:, None]], dim=1)
        keep = (ids >= 0).float()
        bag = (self.p["embedding"][ids.clamp_min(0)] * keep[..., None]).sum(1)
        mean = bag / keep.sum(1)[:, None]
        return torch.log_softmax(mean @ self.p["out"]["W"] + self.p["out"]["b"], dim=-1), ids

    def select(self, states, pos, rows):
        width = max(s.shape[1] for s in states)
        pad = [torch.nn.functional.pad(s, (0, width - s.shape[1]), value=-1) for s in states]
        return torch.stack(pad)[pos, rows]
'''

STUB_CONFIG = {"name": "bow-tiny", "family": "bow", "source": "a test's stub", "reduced": [],
               "model": {"vocab_size": 400, "embed_size": 32},
               "serve": {"precision": "default", "quantize": True, "beam_width": 6,
                         "max_word_len": 5},
               "weights": {"embedding": 1.0, "head_W": 0.5, "head_b": 0.5}}

# run in the copy, as its own ``benchmark`` package
STUB_RUN = '''
import json, sys

sys.path.insert(0, sys.argv[1])
import torch

import benchmark
from benchmark.core import registry
from benchmark.core.run_cell import correct
from benchmark.core.serve import compare
from benchmark.core.weights import dequantize_params, make_weights, quantize_params
from benchmark.reference.beam import beam_search

assert benchmark.__file__.startswith(sys.argv[1]), benchmark.__file__
cpu = torch.device("cpu")
cell = registry.workload("serve.bow.synthetic")
cfg = registry.config(cell["config"])
fam = registry.family_of(cfg)
model, serve, tp = cfg["model"], cfg["serve"], cell["traffic"]
traffic = registry.traffic(tp["kind"]).build(tp, model, 2**31 + 5)
leaves = fam.leaves(model)
w = make_weights(leaves, cfg["weights"], 2**31 + 5, cpu)
q = quantize_params(w, leaves)
dq = dequantize_params(q, leaves)
sample = traffic.job(0)[:12]
lex, beam, M = traffic.lexicon, serve["beam_width"], serve["max_word_len"]
N = tp["max_nodes_per_frame"]
lm = fam.reference_lm(dq, model)
served = [(s, [w for w, _ in nodes]) for s, nodes in beam_search(lm, sample, lex, beam, M, N, cpu)]
args = ([(k, None) for k in sample], lex, beam, M, N, cpu, 0, cell["limits"])
raised = [(s + 1.0, p) for s, p in served]
print(json.dumps({
    "families": registry.names("families"),
    "int8": [str(t.dtype) for t in (q["embedding"]["q"], q["out"]["W"]["q"], q["out"]["b"])],
    "round_trip": max(float((dq[k] - w[k]).abs().max()) for k in ("embedding",)),
    "half_step": float(q["embedding"]["scale"].max()) / 2,
    "ops": fam.serve_ops(sample, model, serve, lex.by_reading(), M),
    "chars": sum(len(k) for k in sample), "n": len(sample),
    "sound": correct(compare(lm, *args, served=served)),
    "raised": correct(compare(lm, *args, served=raised)),
    "paths": sum(len(p) for _, p in served),
}))
'''


def _copy(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    return copy, {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    return env


def test_a_second_family_joins_by_new_files_alone(tmp_path):
    copy, before = _copy(tmp_path)
    (copy / "families" / "bow.py").write_text(STUB_FAMILY)
    (copy / "reference" / "bow.py").write_text(STUB_REFERENCE)
    (copy / "configs" / "bow-tiny.json").write_text(json.dumps(STUB_CONFIG))
    cell = registry.workload("serve.jlm50k.synthetic.s2048")
    cell.update(name="serve.bow.synthetic", config="bow-tiny", why="the bag-of-words stub")
    cell["traffic"].update(name="synthetic147.bow", pool_sentences=300, job_sentences=24)
    (copy / "workloads" / "serve.bow.synthetic.json").write_text(json.dumps(cell))
    assert all(p.read_bytes() == b for p, b in before.items())
    got = subprocess.run([sys.executable, "-c", STUB_RUN, str(tmp_path)], cwd=tmp_path,
                         capture_output=True, text=True, env=_env(), timeout=600)
    assert got.returncode == 0, got.stderr[-4000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert all(p.read_bytes() == b for p, b in before.items())
    assert out["families"] == ["bow", "lstm"]
    assert out["int8"] == ["torch.int8", "torch.int8", "torch.float32"]
    assert 0 < out["round_trip"] <= out["half_step"] * (1 + 1e-6)
    rows = (out["chars"] + out["n"]) * 6
    assert out["ops"] == {"bf16": float(rows * 2 * 32 * 400)}
    assert out["paths"] >= out["n"]
    assert out["sound"] and not out["raised"]


def test_an_unknown_or_missing_family_fails_naming_its_path(tmp_path):
    with pytest.raises(FileNotFoundError, match=os.path.join("families", "nosuch.py")):
        registry.family_of({"name": "x", "family": "nosuch"})
    with pytest.raises(ValueError, match=os.path.join("configs", "x.json") + ' has no "family"'):
        registry.family_of({"name": "x"})
    # a cell of such a configuration fails when it starts, before it looks for a card
    copy, _ = _copy(tmp_path)
    cfg = registry.config("jlm-50k-1l")
    cfg.update(name="ghost", family="nosuch")
    (copy / "configs" / "ghost.json").write_text(json.dumps(cfg))
    cell = registry.workload("serve.jlm50k.synthetic.s2048")
    cell.update(name="serve.ghost", config="ghost")
    (copy / "workloads" / "serve.ghost.json").write_text(json.dumps(cell))
    env = dict(_env(), PYTHONPATH=registry.ROOT)  # the program, and the copy's harness
    got = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "serve.ghost",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=600)
    assert got.returncode == 2 and got.stdout.strip() == ""
    assert str(copy / "families" / "nosuch.py") in got.stderr
