"""Native (C++) host-side components, loaded via ctypes.

The port's lattice builder + bit-packer feeding the device engine, with
the same output as :mod:`jlm_tpu.native` but its own ``lattice.cpp``: one
call packs a whole chunk, over a codepoint trie, with no heap allocation a
sentence.  Native C++ compiled on first use with the system toolchain (no
pybind11 / pip in the image; plain ``g++ -O3 -shared`` + ctypes).  Falls
back to the pure-Python builder transparently if no compiler is available.
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
        if not os.path.exists(so):  # built aside and renamed: processes may race
            part = f"{so}.{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", part],
                check=True, capture_output=True,
            )
            os.replace(part, so)
        lib = ctypes.CDLL(so)
        lib.jlm_lexicon_create.restype = ctypes.c_void_p
        lib.jlm_lexicon_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.jlm_lexicon_destroy.argtypes = [ctypes.c_void_p]
        lib.jlm_build_packed_batch.restype = ctypes.c_int64
        lib.jlm_build_packed_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p,
        ]
        _lib = lib
    except Exception as e:  # no compiler / load failure → python fallback
        _lib_error = str(e)
    return _lib


def available() -> bool:
    return _load_lib() is not None


def _u32(strings: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """``strings`` as one UTF-32 codepoint array and its ``[n + 1]`` offsets
    (a ``str``'s length is its number of codepoints)."""
    codes = np.frombuffer("".join(strings).encode("utf-32-le"), dtype=np.uint32)
    offsets = np.zeros(len(strings) + 1, np.int64)
    np.cumsum([len(x) for x in strings], out=offsets[1:])
    return codes, offsets


class NativeLatticeBuilder:
    """Drop-in producer of the engine's (packed, lengths) upload tensors.

    Bit-identical to ``pack_lattice_batch([build_lattice(...)])`` — pinned
    by tests — at one native call a chunk.
    """

    def __init__(self, lexicon: Lexicon, config: Config):
        lib = _load_lib()
        assert lib is not None, f"native lib unavailable: {_lib_error}"
        self._lib = lib
        self.config = config

        readings, r_off = _u32(list(lexicon.by_reading))
        r_off = r_off.astype(np.int32)
        ids = np.asarray([w for wids in lexicon.by_reading.values() for w in wids], np.int32)
        id_off = np.zeros(len(lexicon.by_reading) + 1, np.int32)
        np.cumsum([len(wids) for wids in lexicon.by_reading.values()], out=id_off[1:])
        self._handle = lib.jlm_lexicon_create(
            readings.ctypes.data, r_off.ctypes.data, ids.ctypes.data, id_off.ctypes.data,
            np.int32(len(lexicon.by_reading)), np.int32(UNK_ID),
        )

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.jlm_lexicon_destroy(self._handle)
            self._handle = None

    def pack_batch(self, kanas: List[str],
                   width: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """``kanas``' packed lattices ``[S, width, N]`` (frames past ``width``
        left out; default ``config.max_kana_len``) and lengths ``[S]``."""
        from jlm_tpu_torch.decoder.lattice import handle_node_overflow

        cfg = self.config
        S = len(kanas)
        W = cfg.max_kana_len if width is None else int(width)
        codes, offsets = _u32(kanas)
        lengths = np.diff(offsets).astype(np.int32)
        if lengths.min(initial=1) < 1 or lengths.max(initial=0) > cfg.max_kana_len:
            raise ValueError(f"kana lengths {lengths.min()}..{lengths.max()} outside "
                             f"1..max_kana_len {cfg.max_kana_len}")
        packed = np.zeros((S, W, cfg.max_nodes_per_frame), np.int32)
        # rc >= 0: nodes dropped beyond the per-frame budget; rc = -(s + 1):
        # sentence s overflows a lookahead row (always fatal).
        rc = self._lib.jlm_build_packed_batch(
            self._handle, codes.ctypes.data, offsets.ctypes.data, np.int32(S),
            np.int32(W), np.int32(cfg.max_nodes_per_frame), np.int32(cfg.max_lookahead),
            np.int32(cfg.max_word_len), packed.ctypes.data,
        )
        if rc < 0:
            raise ValueError(f"lookahead overflow for {kanas[-rc - 1]!r} (sentence {-rc - 1}): "
                             "raise max_lookahead")
        handle_node_overflow(rc, cfg, f"native batch of {S}")
        return packed, lengths
