"""The PyTorch port never imports JAX and builds no kernel at import."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_engine_import_is_jax_free_and_builds_nothing():
    code = (
        "import sys\n"
        "import jlm_tpu_torch.decoder.engine\n"
        "import jlm_tpu_torch.decoder.incremental\n"
        "import jlm_tpu_torch.decoder.server\n"
        "import jlm_tpu_torch.decoder.suggest\n"
        "import jlm_tpu_torch.models.params\n"
        "import jlm_tpu_torch.data.realistic, jlm_tpu_torch.data.synthetic_ctx\n"
        "import jlm_tpu_torch.eval.ceiling, jlm_tpu_torch.eval.conversion\n"
        "import jlm_tpu_torch.oracle.ngram, jlm_tpu_torch.utils.logging\n"
        "import jlm_tpu_torch.train.import_reference\n"
        "import jlm_tpu_torch.parallel, jlm_tpu_torch.parallel.comm, jlm_tpu_torch.parallel.mesh\n"
        "import jlm_tpu_torch.parallel.sharded_head, jlm_tpu_torch.parallel.train_step\n"
        "import jlm_tpu_torch.parallel.comms_model\n"
        "from jlm_tpu_torch.scripts import (bench_all, bench_server, convert, eval_conversion,\n"
        "                                   eval_ppl, export_int8, import_reference_weights,\n"
        "                                   quality_ceiling)\n"
        "import jlm_tpu_torch.utils.profiling\n"
        "from jlm_tpu_torch.ops import _build\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert _build._lib is None\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="")  # no nvcc reachable: an import-time build would fail
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_runs_without_the_jax_package():
    """Every module of the port (its CLIs and ``parallel`` among them),
    the root scripts and the sharded tests' rank worker (what a spawned
    rank imports; tests/test_torch_sharded*.py check every rank's modules
    too) import, and a tiny CPU decode (one input past ``max_kana_len``), a few
    keystrokes through the per-keystroke decoder,
    the server and the suggester, and a tiny ``--pallas-scan`` training
    step run, with no module of JAX or of ``jlm_tpu`` loaded and no kernel
    built."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import jlm_tpu_torch\n"
        "for m in pkgutil.walk_packages(jlm_tpu_torch.__path__, 'jlm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, long_witness, profile_keystroke, profile_serve, profile_train, time_kernels\n"
        "from jlm_tpu_torch.config import Config\n"
        "from jlm_tpu_torch.data import (Lexicon, build_vocab, encode_corpus,\n"
        "                                generate_corpus, split_corpus)\n"
        "from jlm_tpu_torch.decoder.engine import BeamDecoder\n"
        "from jlm_tpu_torch.models.params import init_params\n"
        "from jlm_tpu_torch.ops import _build\n"
        "from jlm_tpu_torch.train import Trainer\n"
        "cfg = Config(vocab_size=256, embed_size=32, hidden_size=64, beam_width=4,\n"
        "             max_kana_len=30, batch_size=4, num_steps=8)\n"
        "lines = generate_corpus(400, seed=1234)\n"
        "vocab = build_vocab(lines, 256)\n"
        "dec = BeamDecoder(init_params(cfg), Lexicon.from_vocab(vocab), vocab, cfg,\n"
        "                  precision='default', device='cpu')\n"
        "assert dec.decode('きょうはいい')[0].surface\n"
        "assert dec.decode('きょうはいいてんき' * 4)[0].surface  # decode_long\n"
        "from jlm_tpu_torch.decoder import IncrementalDecoder, SessionServer, Suggester\n"
        "p, lex = init_params(cfg), Lexicon.from_vocab(vocab)\n"
        "inc = IncrementalDecoder(p, lex, vocab, cfg, precision='default', speculate=2,\n"
        "                         use_kernel=True, device='cpu')\n"
        "assert [inc.push(ch) for ch in 'きょう'][-1][0].surface\n"
        "srv = SessionServer(p, lex, vocab, cfg, max_sessions=2, device='cpu')\n"
        "sid = srv.open()\n"
        "srv.push([(sid, 'き')])\n"
        "assert srv.results(sid)[0].surface\n"
        "assert len(Suggester(p, vocab, cfg, device='cpu').suggest([5], k=2)) == 2\n"
        "train = split_corpus(encode_corpus(lines, vocab))[0]\n"
        "tr = Trainer(cfg.replace(use_pallas_scan=True, fused_ce=True), device='cpu')\n"
        "assert next(tr.train_steps(train[:400], epoch=0))[0].item() > 0\n"
        "sys.path.insert(0, 'tests')\n"
        "import _torch_dist_worker\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'jlm_tpu'))\n"
        "assert not bad, bad\n"
        "assert _build._lib is None\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="")  # no nvcc reachable: a build would fail
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
