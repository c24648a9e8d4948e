"""Batched beam-Viterbi search on the device (``engine``) and per-keystroke
serving: ``IncrementalDecoder`` (one session), ``SessionServer`` (batched
sessions) and ``Suggester`` (next words).

The three load on first use: ``oracle.decoder`` imports
``decoder.lattice``, and the serving modules import the oracle's
``DecodeResult``."""

_EXPORTS = {"IncrementalDecoder": "incremental", "SessionServer": "server",
            "Suggester": "suggest"}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
