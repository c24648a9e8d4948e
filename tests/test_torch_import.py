"""The PyTorch port never imports JAX and builds no kernel at import."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_engine_import_is_jax_free_and_builds_nothing():
    code = (
        "import sys\n"
        "import jlm_tpu_torch.decoder.engine\n"
        "import jlm_tpu_torch.models.params\n"
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
