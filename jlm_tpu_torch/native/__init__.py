"""Native (C++) host-side components, loaded via ctypes.

The port's copy of :mod:`jlm_tpu.native` (the lattice builder; ``lattice.cpp``
is the same source).  The host-side runtime around the device search —
here the lattice builder + bit-packer feeding the device engine — is
native C++ compiled on first use with the system toolchain (no pybind11 /
pip in the image; plain ``g++ -O3 -shared`` + ctypes).  Falls back to the
pure-Python builder transparently if no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from jlm_tpu_torch.config import Config, UNK_ID
from jlm_tpu_torch.data.corpus import Vocab
from jlm_tpu_torch.data.lexicon import Lexicon

_SRC = os.path.join(os.path.dirname(__file__), "lattice.cpp")
_lib = None
_lib_error: Optional[str] = None


def _load_lib():
    """Compile (cached by source hash) and dlopen the native library."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(tempfile.gettempdir(), f"jlm_liblattice_{tag}.so")
        if not os.path.exists(so):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", so],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(so)
        lib.jlm_lexicon_create.restype = ctypes.c_void_p
        lib.jlm_lexicon_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.jlm_lexicon_destroy.argtypes = [ctypes.c_void_p]
        lib.jlm_build_packed.restype = ctypes.c_int32
        lib.jlm_build_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ]
        _lib = lib
    except Exception as e:  # no compiler / load failure → python fallback
        _lib_error = str(e)
    return _lib


def available() -> bool:
    return _load_lib() is not None


def _u32(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)


class NativeLatticeBuilder:
    """Drop-in producer of the engine's (packed, lengths) upload tensors.

    Bit-identical to ``pack_lattice_batch([build_lattice(...)])`` — pinned
    by tests — but ~100× less host time per sentence.
    """

    def __init__(self, lexicon: Lexicon, config: Config):
        lib = _load_lib()
        assert lib is not None, f"native lib unavailable: {_lib_error}"
        self._lib = lib
        self.config = config

        readings: List[np.ndarray] = []
        r_off = [0]
        ids: List[int] = []
        id_off = [0]
        for reading, wids in lexicon.by_reading.items():
            readings.append(_u32(reading))
            r_off.append(r_off[-1] + len(readings[-1]))
            ids.extend(wids)
            id_off.append(len(ids))
        self._readings = np.concatenate(readings) if readings else np.zeros(0, np.uint32)
        self._r_off = np.asarray(r_off, np.int32)
        self._ids = np.asarray(ids, np.int32)
        self._id_off = np.asarray(id_off, np.int32)
        self._handle = lib.jlm_lexicon_create(
            self._readings.ctypes.data, self._r_off.ctypes.data,
            self._ids.ctypes.data, self._id_off.ctypes.data,
            np.int32(len(lexicon.by_reading)),
        )

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.jlm_lexicon_destroy(self._handle)
            self._handle = None

    def pack_batch(self, kanas: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        from jlm_tpu_torch.decoder.lattice import handle_node_overflow

        cfg = self.config
        S = len(kanas)
        packed = np.zeros((S, cfg.max_kana_len, cfg.max_nodes_per_frame),
                          np.int32)
        lengths = np.zeros((S,), np.int32)
        dropped = 0
        for i, kana in enumerate(kanas):
            u = _u32(kana)
            T = len(u)
            assert 0 < T <= cfg.max_kana_len, (
                f"kana length {T} exceeds max_kana_len {cfg.max_kana_len}"
            )
            # rc >= 0: count of nodes dropped beyond the per-frame budget;
            # rc == -1: lookahead overflow (always fatal).
            rc = self._lib.jlm_build_packed(
                self._handle, u.ctypes.data, np.int32(T),
                np.int32(cfg.max_kana_len), np.int32(cfg.max_nodes_per_frame),
                np.int32(cfg.max_lookahead), np.int32(cfg.max_word_len),
                np.int32(UNK_ID), packed[i].ctypes.data,
            )
            assert rc >= 0, f"lookahead overflow for {kana!r}: raise max_lookahead"
            dropped += rc
            lengths[i] = T
        handle_node_overflow(dropped, cfg, f"native batch of {S}")
        return packed, lengths
