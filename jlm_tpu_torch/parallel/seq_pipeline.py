"""Sequence (time-block) pipeline parallelism for the LSTM over a BPTT window.

Counterpart of :mod:`jlm_tpu.parallel.seq_pipeline`.  The window's time
axis is cut into one block per rank of a :class:`~jlm_tpu_torch.parallel.
mesh.SeqMesh`: rank ``p`` holds time block ``p`` of every microbatch and
hands its per-layer ``(c, h)`` carries to rank ``p + 1``.  Parallelism
comes from pipelining ``M`` microbatches: in round ``r`` rank ``p`` runs
microbatch ``m = r - p`` (active when ``0 <= m < M``; stage 0 starts from
the stream's ``c0/h0[m]``, the others from the carry they received), so
after ``M + P - 1`` rounds every microbatch has passed every block.

JAX's ``ppermute`` becomes :func:`~jlm_tpu_torch.parallel.comm.
shift_right` (forward, the carries) and :func:`~jlm_tpu_torch.parallel.
comm.shift_left` (backward, their cotangents), each one ``all_reduce``
that every rank makes in every round, active or not.  The pipeline is one
``torch.autograd.Function``: its backward walks the rounds from the last
to the first, takes each active round's block VJP locally (the block
recomputed from the inputs the forward kept) and makes one leftward
exchange a round, so every rank makes the same exchanges in the same
order (on rank 0 the received carry feeds nothing, so autograd's own
order would differ from rank to rank).  The final carries live on the
last stage; a ``broadcast`` from it gives every rank the next window's
whole state, and their cotangents are summed over the group on the way
back (the broadcast's transpose).

Gradients of the replicated inputs (the layers' weights, ``c0``, ``h0``)
are each rank's own share: the caller sums them over the seq group, once.
The blocks are plain torch ops (the reference's XLA glue; no kernel).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from jlm_tpu_torch.ops.lstm_cell import lstm_cell_ref
from jlm_tpu_torch.parallel import comm
from jlm_tpu_torch.parallel.mesh import SeqMesh

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _block_scan(layers: Layers, forget_bias: float, x, c, h):
    """The stack over one block, each layer the port's plain cell
    (``concat([x, h[l]]) @ W + b``, gates i, j, f, o, ``forget_bias`` on f):
    ``x [B, TB, E]``, ``c, h [L, B, H]`` -> ``(c', h', tops [B, TB, H])``."""
    tops = []
    for t in range(x.shape[1]):
        top, new_c, new_h = x[:, t], [], []
        for l, (W, b) in enumerate(layers):
            cl, top = lstm_cell_ref(top, h[l], c[l], W, b, forget_bias)
            new_c.append(cl)
            new_h.append(top)
        c, h = torch.stack(new_c), torch.stack(new_h)
        tops.append(top)
    return c, h, torch.stack(tops, dim=1)


def _pairs(flat: Sequence[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return [(flat[2 * l], flat[2 * l + 1]) for l in range(len(flat) // 2)]


class _SeqPipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh: SeqMesh, forget_bias: float, xs, c0, h0, *flat):
        P, p, g = mesh.seq, mesh.rank, mesh.group
        M = xs.shape[0]
        layers = _pairs(flat)
        hs = xs.new_zeros(xs.shape[:3] + (c0.shape[-1],))
        done = torch.zeros((2,) + tuple(c0.shape), dtype=c0.dtype, device=c0.device)
        carry_in = torch.zeros_like(done)  # [2, M, L, B, H]: each microbatch's stage input
        recv = torch.zeros_like(done[:, 0])
        rounds = M + P - 1
        for r in range(rounds):
            m = r - p
            if 0 <= m < M:
                carry_in[:, m] = torch.stack([c0[m], h0[m]]) if p == 0 else recv
                c, h, hs[m] = _block_scan(layers, forget_bias, xs[m], carry_in[0, m],
                                          carry_in[1, m])
                send = torch.stack([c, h])
                if p == P - 1:
                    done[:, m] = send
            else:
                send = torch.zeros_like(recv)
            if r + 1 < rounds:  # the last round's carries go nowhere
                recv = comm.shift_right(send, g)
        done = comm.broadcast(done, g, src=P - 1)
        ctx.mesh, ctx.forget_bias = mesh, forget_bias
        ctx.save_for_backward(xs, carry_in, *flat)
        return hs, done[0], done[1]

    @staticmethod
    def backward(ctx, g_hs, g_c, g_h):
        mesh, forget_bias = ctx.mesh, ctx.forget_bias
        P, p, g = mesh.seq, mesh.rank, mesh.group
        xs, carry_in, *flat = ctx.saved_tensors
        M = xs.shape[0]
        # every rank holds the final carries: their cotangent is the sum of
        # every rank's, and enters the last stage's blocks
        g_T = comm.all_reduce_sum(torch.stack([g_c, g_h]).contiguous(), g)
        g_xs = torch.zeros_like(xs)
        g_in = torch.zeros_like(carry_in)  # rank 0's: the cotangents of c0, h0
        g_flat = [torch.zeros_like(t) for t in flat]
        g_recv = torch.zeros_like(carry_in[:, 0])
        for r in reversed(range(M + P - 1)):
            m = r - p
            send = torch.zeros_like(g_recv)
            if 0 <= m < M:
                g_out = g_T[:, m] if p == P - 1 else g_recv
                with torch.enable_grad():
                    x = xs[m].detach().requires_grad_(True)
                    cin = carry_in[0, m].detach().requires_grad_(True)
                    hin = carry_in[1, m].detach().requires_grad_(True)
                    lw = [t.detach().requires_grad_(True) for t in flat]
                    c, h, tops = _block_scan(_pairs(lw), forget_bias, x, cin, hin)
                    grads = torch.autograd.grad((c, h, tops), [x, cin, hin] + lw,
                                                (g_out[0], g_out[1], g_hs[m]))
                g_xs[m] = grads[0]
                for acc, gl in zip(g_flat, grads[3:]):
                    acc += gl
                if p == 0:
                    g_in[:, m] = torch.stack(grads[1:3])
                else:
                    send = torch.stack(grads[1:3])
            if r > 0:  # round 0's cotangents have no stage before them
                g_recv = comm.shift_left(send, g)
        return (None, None, g_xs, g_in[0], g_in[1], *g_flat)


def make_seq_pipeline_scan(mesh: SeqMesh, num_layers: int = 1, forget_bias: float = 1.0):
    """Returns ``fn(xs [M, B, TB, E], layers ((W, b), ...), c0, h0 [M, L, B,
    H]) -> (hs [M, B, TB, H], c_T, h_T [M, L, B, H])``: ``xs`` and ``hs``
    this rank's time block of every microbatch, the final carries the
    whole stream's on every rank.  Every rank of the mesh calls it, with
    the same shapes.

    Equals a sequential scan over each microbatch (:func:`seq_pipeline_ref`,
    over the window's blocks in rank order); ``M`` must divide by the
    number of stages (the reference's rule)."""
    P = mesh.seq

    def fn(xs, layers, c0, h0):
        if len(layers) != num_layers:
            raise ValueError(f"{len(layers)} layers given, {num_layers} expected")
        if xs.shape[0] % P:
            raise ValueError(f"microbatch count {xs.shape[0]} must divide by the seq axis {P}")
        flat = [t for W_b in layers for t in W_b]
        return _SeqPipeline.apply(mesh, forget_bias, xs, c0, h0, *flat)

    return fn


def seq_pipeline_ref(xs, layers: Layers, c0, h0, forget_bias: float = 1.0):
    """Sequential reference: an independent multi-layer scan per microbatch
    over the whole window, ``xs [M, B, T, E]`` -> ``(hs [M, B, T, H], c_T,
    h_T [M, L, B, H])``."""
    outs = [_block_scan(layers, forget_bias, xs[m], c0[m], h0[m]) for m in range(xs.shape[0])]
    return (torch.stack([o[2] for o in outs]), torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))
