"""PyTorch port parameter bridge and npz checkpoint reader."""

import numpy as np
import pytest
import torch

from jlm_tpu.config import Config
from jlm_tpu.models.params import init_params, param_spec
from jlm_tpu.ops.quant import quantize_params
from jlm_tpu_torch.models.params import load_npz_params, params_to_torch, resolve_device

CFG = Config(vocab_size=256, embed_size=32, hidden_size=64, num_layers=2, seed=3)


def _flat(tree, prefix=""):
    """name -> leaf, walking dicts and lists like the checkpoint keys."""
    if isinstance(tree, dict):
        return {n: v for k in tree for n, v in _flat(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {n: v for i, x in enumerate(tree) for n, v in _flat(x, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("quantized", [False, True])
def test_params_to_torch_keeps_tree_and_dtypes(quantized):
    """Every leaf arrives with its name, shape, dtype and value: int8 ``q``
    stays int8 with an fp32 scale."""
    params = init_params(CFG)
    if quantized:
        params = quantize_params(params)
    tparams = params_to_torch(params, "cpu")
    src, dst = _flat(params), _flat(tparams)
    assert src.keys() == dst.keys()
    for name, arr in src.items():
        t = dst[name]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert str(t.dtype) == f"torch.{arr.dtype}", name
        np.testing.assert_array_equal(t.numpy(), arr)
    if quantized:
        assert tparams["head"]["W"]["q"].dtype == torch.int8
        assert tparams["head"]["W"]["scale"].dtype == torch.float32
        assert isinstance(tparams["lstm"], list) and len(tparams["lstm"]) == 2


@pytest.mark.parametrize("quantized", [False, True])
def test_load_npz_round_trip(tmp_path, quantized):
    """A checkpoint written by jlm_tpu.train.checkpoint reads back through
    the port's own reader to the same pytree (int8 leaves included)."""
    from jlm_tpu.train.checkpoint import load_checkpoint, save_checkpoint

    params = init_params(CFG)
    if quantized:
        params = quantize_params(params)
    save_checkpoint(str(tmp_path), params, CFG, tag="t")
    got = load_npz_params(str(tmp_path / "ckpt-t.npz"))
    want, _ = load_checkpoint(str(tmp_path), tag="t")
    assert param_spec(got) == param_spec(want) == param_spec(params)
    for name, arr in _flat(params).items():
        np.testing.assert_array_equal(_flat(got)[name], arr)
    assert isinstance(got["lstm"], list)


def test_cuda_request_without_gpu_raises():
    """Asking for CUDA without a card raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        params_to_torch(init_params(CFG), "cuda")
