"""Everything the benchmark takes from the program under test.

The program is ``jlm_tpu_torch`` (never the JAX package beside it).  It is
imported here and only here, inside functions, so that the reference and
the traffic generators stay free of it and a checkout without the program
fails when a cell starts.  The benchmark hands the program the inputs it
made (weights, the raw lexicon's words, the kana) and takes back its
outputs; the patch points name where the engine and the trainer look each
layer's entry up, for the traced run's wrappers.
"""

from __future__ import annotations

import tempfile
from typing import Any, Dict, List, Tuple

from benchmark.data.lexicon import RawLexicon


def require() -> None:
    """Fail unless the program is there to run (a checkout of the benchmark
    alone measures nothing)."""
    import jlm_tpu_torch  # noqa: F401


def use_build_dir(root: str) -> None:
    """Keep the program's native (g++) lattice library in a fixed directory
    of the checkout: it builds into ``tempfile.gettempdir()``."""
    import os

    os.makedirs(root, exist_ok=True)
    tempfile.tempdir = root


def make_config(model: Dict[str, Any], section: Dict[str, Any], **extra):
    """The program's ``Config`` for a configuration file's ``model`` section
    and its ``serve`` or ``train`` section."""
    from jlm_tpu_torch.config import Config, DSoftmaxConfig

    fields = {k: v for k, v in model.items() if k != "dsoftmax"}
    if model.get("dsoftmax"):
        ds = model["dsoftmax"]
        fields["dsoftmax"] = DSoftmaxConfig(block_sizes=tuple(ds["block_sizes"]),
                                            block_dims=tuple(ds["block_dims"]),
                                            mode=ds["mode"])
    program = {k: v for k, v in section.items() if k != "precision"}
    return Config(**fields, **program, **extra)


def make_vocab(lex: RawLexicon):
    """The program's ``Vocab`` and ``Lexicon`` over the raw lexicon's words."""
    from jlm_tpu_torch.data.corpus import Token, Vocab
    from jlm_tpu_torch.data.lexicon import Lexicon

    tokens = [Token(*w) for w in lex.words]
    vocab = Vocab(tokens=tokens, id_of={t.key: i for i, t in enumerate(tokens)},
                  counts=lex.counts)
    return vocab, Lexicon.from_vocab(vocab)


def make_decoder(params, lex: RawLexicon, config, precision: str, device):
    from jlm_tpu_torch.decoder.engine import BeamDecoder

    vocab, lexicon = make_vocab(lex)
    return BeamDecoder(params, lexicon, vocab, config, precision=precision, device=device)


def make_trainer(config, params, device):
    from jlm_tpu_torch.train.trainer import Trainer

    return Trainer(config, params, device=device)


def flat_params(trainer) -> Dict[str, Any]:
    """The trainer's leaves by ``a/0/b`` path (the tensors it updates)."""
    return trainer.flat


def first_moments(trainer) -> Dict[str, Any]:
    return trainer.opt_state.mu


ADAM_B1 = 0.9


def serve_patch_points() -> List[Tuple[Any, str, str]]:
    """``(owner, attribute, layer label)`` the serve wrappers replace."""
    from jlm_tpu_torch.decoder import engine

    return [(engine.BeamDecoder, "_pack", "pack"),
            (engine.BeamDecoder, "materialize", "materialize"),
            (engine, "_decode_scan", "decode_scan"),
            (engine, "project_lse", "project_lse"),
            (engine, "lstm_cell_step", "lstm_cell"),
            (engine, "cand_dot", "cand_dot")]


def train_patch_points() -> List[Tuple[Any, str, str]]:
    from jlm_tpu_torch.models import heads
    from jlm_tpu_torch.ops import lstm_scan, softmax_ce
    from jlm_tpu_torch.train import optim, trainer

    return [(trainer.Trainer, "_train_step", "train_step"),
            (trainer.Trainer, "_loss", "forward"),
            (heads, "ce_loss_fused", "softmax_ce"),
            (softmax_ce, "ce_bwd", "softmax_ce"),
            (lstm_scan, "lstm_scan_fwd", "lstm_scan"),
            (lstm_scan, "lstm_scan_bwd", "lstm_scan"),
            (optim, "apply_gradients", "optimizer")]
