"""State-space and recurrent blocks; port of ``repro/models/ssm.py``:
Mamba (selective SSM, ``:35-150``), and the xLSTM pair, mLSTM (matrix
memory, chunkwise parallel) and sLSTM (scalar memory, sequential
recurrence, ``:157-404``).

Precision follows the reference: where it asks a product of bf16
operands for an f32 result (``preferred_element_type=f32``), the port
upcasts the operands to f32 before the product, since a bf16 matmul in
torch rounds its result to bf16. In float32 the upcasts are no-ops.
Keep TF32 off on the card (``torch.backends.cuda.matmul.allow_tf32``).

All three run in torch ops: the reference computes them outside any
Pallas kernel. Mamba's chunk scan is ``associative_scan``, a copy of
``jax.lax.associative_scan``'s odd/even recursion, so it combines the
elements in the reference's order in 2 log2(c) levels of whole-tensor
ops (no loop over tokens); the chunks run in a loop, each recomputed in
the backward as the reference's ``jax.checkpoint(chunk_step)`` is.
sLSTM's backward is hand-written (``SlstmScan``), as the reference's
``jax.custom_vjp`` is; ``slstm_scan_plain`` is the same recurrence under
torch's own autograd, the yardstick of its tests.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.spec import TensorSpec

__all__ = ["mamba_spec", "mamba", "associative_scan", "mlstm_spec", "mlstm",
           "slstm_spec", "slstm", "slstm_scan", "slstm_scan_plain", "SlstmScan"]

F32 = torch.float32


def _chunk_len(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (shapes are static)."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _up(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and read back as f32: a bf16 operand of
    a product whose result the reference keeps in f32."""
    return x.to(dtype).float()


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def mamba_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    ds = cfg.ssm_state
    dtr = _dt_rank(cfg)
    return {
        "in_proj": TensorSpec((d, 2 * di), ("embed", "mlp")),
        "conv_w": TensorSpec((cfg.ssm_conv, di), (None, "mlp"), scale=cfg.ssm_conv ** -0.5),
        "conv_b": TensorSpec((di,), ("mlp",), init="zeros"),
        "x_proj": TensorSpec((di, dtr + 2 * ds), ("mlp", None)),
        "dt_proj": TensorSpec((dtr, di), (None, "mlp"), scale=dtr ** -0.5),
        "dt_bias": TensorSpec((di,), ("mlp",), init="zeros"),
        "a_log": TensorSpec((di, ds), ("mlp", None), init="ones"),
        "d_skip": TensorSpec((di,), ("mlp",), init="ones"),
        "out_proj": TensorSpec((di, d), ("mlp", "embed")),
    }


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``, which is ``jnp.logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)) in ``x``'s dtype (``F.softplus`` returns ``x`` past
    a threshold and rounds otherwise below it), with ``logaddexp``'s
    custom JVP as its backward: the cotangent times exp(x - out)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def _slice(t: torch.Tensor, axis: int, start: int, stop: int | None,
           step: int = 1) -> torch.Tensor:
    return t[(slice(None),) * axis + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """``a[0], b[0], a[1], b[1], ...`` along ``axis``; ``a`` is as long as
    ``b`` or one longer."""
    nb = b.shape[axis]
    out = torch.stack([_slice(a, axis, 0, nb), b], dim=axis + 1).flatten(axis, axis + 1)
    if a.shape[axis] > nb:
        out = torch.cat([out, _slice(a, axis, nb, None)], dim=axis)
    return out


def associative_scan(fn, elems: list, axis: int = 0) -> list:
    """Inclusive scan of ``fn`` over ``axis`` of every tensor of ``elems``
    (a list of tensors of one length along ``axis``), with
    ``jax.lax.associative_scan``'s recursion, so its combines are the
    reference's, in its order: combine adjacent pairs, scan those
    recursively (the odd elements of the result), combine each with the
    next even element of the input (the even ones), interleave. ``fn``
    takes and returns lists of tensors."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems
    reduced = fn([_slice(e, axis, 0, -1, 2) for e in elems],
                 [_slice(e, axis, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn([_slice(e, axis, 0, -1) for e in odd],
                  [_slice(e, axis, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [_slice(e, axis, 2, None, 2) for e in elems])
    even = [torch.cat([_slice(e, axis, 0, 1), r], dim=axis) for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


def _combine(e1: list, e2: list) -> list:
    """The linear recurrence's combine: (a1, b1) then (a2, b2) is
    (a1 a2, b1 a2 + b2)."""
    a1, b1 = e1
    a2, b2 = e2
    return [a1 * a2, b1 * a2 + b2]


def _mamba_gates(p: dict, cfg: ModelConfig, xz: torch.Tensor, conv_state=None):
    """Shared front half: split, causal depthwise conv, selective params.
    xz: (B, S, 2*di). Returns (x, z, dt, bsel, csel, new_conv_state)."""
    di = cfg.ssm_expand * cfg.d_model
    ds = cfg.ssm_state
    dtr = _dt_rank(cfg)
    x, z = xz[..., :di], xz[..., di:]
    dt_ = x.dtype

    k = cfg.ssm_conv
    if conv_state is None:  # full-sequence causal depthwise conv
        b, s = x.shape[:2]
        pad = torch.zeros((b, k - 1, di), dtype=dt_, device=x.device)
        xp = torch.cat([pad, x], dim=1)
        new_conv_state = xp[:, xp.shape[1] - (k - 1):] if k > 1 else pad
        w = p["conv_w"].to(dt_)
        acc = xp[:, 0:s] * w[0]
        for i in range(1, k):       # the reference's sum(), in its order
            acc = acc + xp[:, i:i + s] * w[i]
        x = acc
    else:  # single step: conv_state (B, k-1, di)
        window = torch.cat([conv_state, x], dim=1)            # (B, k, di)
        new_conv_state = window[:, 1:]
        x = torch.einsum("bkd,kd->bd", window, p["conv_w"].to(dt_))[:, None, :]
    x = F.silu(x + p["conv_b"].to(dt_))

    sel = torch.einsum("bsd,dr->bsr", x, p["x_proj"].to(dt_))
    dt = _softplus(torch.einsum("bsr,rd->bsd", sel[..., :dtr], p["dt_proj"].to(dt_))
                   + p["dt_bias"].to(dt_))                     # (B,S,di)
    bsel = sel[..., dtr:dtr + ds]                              # (B,S,ds)
    csel = sel[..., dtr + ds:]                                 # (B,S,ds)
    return x, z, dt, bsel, csel, new_conv_state


def _mamba_chunk(a: torch.Tensor, h0: torch.Tensor, dt_c: torch.Tensor,
                 x_c: torch.Tensor, b_c: torch.Tensor, c_c: torch.Tensor):
    """One chunk of the scan, all f32: the (B, c, di, ds) decay and drive,
    their associative scan along the chunk, the carried-in state ``h0``
    applied. Returns (the chunk's last state, y (B, c, di))."""
    dec = torch.exp(dt_c[..., None] * a)                       # (B,c,di,ds)
    drv = (dt_c * x_c)[..., None] * b_c[:, :, None, :]
    acum, hloc = associative_scan(_combine, [dec, drv], axis=1)
    hs = hloc + acum * h0[:, None]                             # (B,c,di,ds)
    y_c = torch.einsum("bcdn,bcn->bcd", hs, c_c)               # (B,c,di)
    return hs[:, -1], y_c


def mamba(p: dict, cfg: ModelConfig, h_in: torch.Tensor, *, state=None,
          conv_state=None):
    """Mamba block. Full-sequence mode (state=None) or decode mode (state
    (B, di, ds) f32, conv_state (B, k-1, di), h_in (B, 1, D)). Returns
    (out, (state, conv_state)). The full sequence runs in chunks of
    ``_chunk_len(s, ssm_chunk)`` tokens, so only one chunk's (B, c, di,
    ds) tensors exist at a time (in the backward too: each chunk is
    recomputed there)."""
    di = cfg.ssm_expand * cfg.d_model
    ds = cfg.ssm_state
    dt_ = h_in.dtype
    xz = torch.einsum("bsd,de->bse", h_in, p["in_proj"].to(dt_))
    a = -torch.exp(p["a_log"].float())                         # (di, ds)

    if state is None:
        x, z, dt, bsel, csel, conv_out = _mamba_gates(p, cfg, xz)
        b, s, _ = x.shape
        c = _chunk_len(s, cfg.ssm_chunk)
        dt32, x32, b32, c32 = dt.float(), x.float(), bsel.float(), csel.float()
        h = torch.zeros((b, di, ds), dtype=F32, device=h_in.device)
        ys = []
        for j in range(s // c):
            sl = slice(j * c, (j + 1) * c)
            h, y_c = L.remat(_mamba_chunk, a, h, dt32[:, sl], x32[:, sl],
                             b32[:, sl], c32[:, sl])
            ys.append(y_c)
        y = torch.cat(ys, dim=1)                               # (B,S,di)
        new_state = h
    else:
        x, z, dt, bsel, csel, conv_out = _mamba_gates(p, cfg, xz, conv_state)
        dta = dt[:, 0].float()                                 # (B,di)
        decay = torch.exp(dta[..., None] * a)                  # (B,di,ds)
        drive = (dta * x[:, 0].float())[..., None] * bsel[:, 0].float()[:, None, :]
        new_state = decay * state + drive
        y = torch.einsum("bdn,bn->bd", new_state, csel[:, 0].float())[:, None]

    y = y.to(dt_) + x * p["d_skip"].to(dt_)
    y = y * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(dt_))
    return out, (new_state, conv_out)


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, chunkwise-parallel)
# ---------------------------------------------------------------------------

def mlstm_spec(cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    return {
        "wq": TensorSpec((d, h, hd), ("embed", "heads", "qkv")),
        "wk": TensorSpec((d, h, hd), ("embed", "heads", "qkv")),
        "wv": TensorSpec((d, h, hd), ("embed", "heads", "qkv")),
        "wi": TensorSpec((d, h), ("embed", "heads"), scale=d ** -0.5),
        "wf": TensorSpec((d, h), ("embed", "heads"), scale=d ** -0.5),
        "wo_gate": TensorSpec((d, h, hd), ("embed", "heads", "qkv")),
        "out": TensorSpec((h, hd, d), ("heads", "qkv", "embed")),
    }


def mlstm(p: dict, cfg: ModelConfig, h_in: torch.Tensor, *, state=None):
    """mLSTM. Training: chunkwise parallel. Decode: state=(C (B,H,hd,hd),
    n (B,H,hd)), h_in (B,1,D). Returns (out, (C, n))."""
    b, s, d = h_in.shape
    nh, hd = cfg.n_heads, cfg.resolved_head_dim
    dt = h_in.dtype
    # The scale in the activations' dtype, as the reference's weakly typed
    # constant is: a Python float would scale bf16 in f32 and round once.
    scale = torch.tensor(hd ** -0.5, dtype=dt, device=h_in.device)
    q = torch.einsum("bsd,dhk->bhsk", h_in, p["wq"].to(dt)) * scale
    k = torch.einsum("bsd,dhk->bhsk", h_in, p["wk"].to(dt)) * scale
    v = torch.einsum("bsd,dhk->bhsk", h_in, p["wv"].to(dt))
    logi = torch.einsum("bsd,dh->bhs", h_in, p["wi"].to(dt)).float()
    logf = F.logsigmoid(torch.einsum("bsd,dh->bhs", h_in, p["wf"].to(dt)).float())

    if state is None:
        c = _chunk_len(s, cfg.ssm_chunk)
        mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=h_in.device))
        C0 = torch.zeros((b, nh, hd, hd), dtype=F32, device=h_in.device)
        n0 = torch.zeros((b, nh, hd), dtype=F32, device=h_in.device)
        ys = []
        for j in range(s // c):
            sl = slice(j * c, (j + 1) * c)
            qq, kk, vv = q[:, :, sl], k[:, :, sl], v[:, :, sl]
            li, lf = logi[:, :, sl], logf[:, :, sl]
            qf = qq.float()
            fcum = torch.cumsum(lf, dim=-1)                    # (B,H,c)
            # intra-chunk: scores_ij = exp(fcum_i - fcum_j + i_j) for i >= j
            logD = fcum[..., :, None] - fcum[..., None, :] + li[..., None, :]
            logD = torch.where(mask, logD, -torch.inf)
            stab = torch.maximum(torch.amax(logD, dim=-1, keepdim=True),
                                 fcum[..., :, None])
            D = torch.exp(logD - stab)                         # (B,H,c,c)
            scores = torch.einsum("bhik,bhjk->bhij", qf, kk.float()) * D
            y_intra = torch.einsum("bhij,bhjk->bhik", _up(scores, qq.dtype),
                                   vv.float())
            # inter-chunk contribution
            inter_w = torch.exp(fcum[..., :, None] - stab)     # (B,H,c,1)
            y_inter = torch.einsum("bhik,bhkl->bhil", qf,
                                   _up(C0, qq.dtype)) * inter_w
            nrm = torch.einsum("bhik,bhk->bhi", qf, _up(n0, qq.dtype))[..., None] \
                * inter_w + scores.sum(dim=-1)[..., None]
            # scores/nrm carry an exp(-stab) scale; the xLSTM "max(|n q|, 1)"
            # floor is 1 in RAW units = exp(-stab) in stabilized units.
            ys.append((y_intra + y_inter)
                      / torch.maximum(torch.abs(nrm), torch.exp(-stab)))
            # state update to end of chunk
            ftot = fcum[..., -1:]                              # (B,H,1)
            wdec = torch.exp(ftot - fcum + li)                 # (B,H,c)
            kw = kk * wdec[..., None].to(kk.dtype)
            C0 = torch.exp(ftot)[..., None] * C0 + torch.einsum(
                "bhjk,bhjl->bhkl", kw.float(), vv.float())
            n0 = torch.exp(ftot) * n0 + torch.sum(kw.float(), dim=-2)
        y = torch.cat(ys, dim=2)                               # (B,H,S,hd)
        new_state = (C0, n0)
    else:
        C0, n0 = state
        i1 = torch.exp(logi[..., 0])                           # (B,H)
        f1 = torch.exp(logf[..., 0])
        k0, v0, q0 = k[:, :, 0].float(), v[:, :, 0].float(), q[:, :, 0].float()
        C1 = f1[..., None, None] * C0 + i1[..., None, None] * torch.einsum(
            "bhk,bhl->bhkl", k0, v0)
        n1 = f1[..., None] * n0 + i1[..., None] * k0
        num = torch.einsum("bhk,bhkl->bhl", q0, C1)
        den = torch.abs(torch.einsum("bhk,bhk->bh", q0, n1))
        y = (num / torch.clamp(den, min=1.0)[..., None])[:, :, None, :]
        new_state = (C1, n1)

    o = torch.sigmoid(torch.einsum("bsd,dhk->bhsk", h_in, p["wo_gate"].to(dt)))
    y = (y.to(dt) * o).transpose(1, 2)                         # (B,S,H,hd)
    out = torch.einsum("bshk,hkd->bsd", y, p["out"].to(dt))
    return out, new_state


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, sequential recurrence)
# ---------------------------------------------------------------------------

def slstm_spec(cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    return {
        "wz": TensorSpec((d, h, hd), ("embed", "heads", "qkv")),
        "wi": TensorSpec((d, h, hd), ("embed", "heads", "qkv"), scale=d ** -0.5),
        "wf": TensorSpec((d, h, hd), ("embed", "heads", "qkv"), scale=d ** -0.5),
        "wo": TensorSpec((d, h, hd), ("embed", "heads", "qkv")),
        # head-local recurrent mats, fused (z|i|f): one (hd, 3hd) product a step
        "r": TensorSpec((h, hd, 3 * hd), ("heads", "qkv", None), scale=hd ** -0.5),
        "out": TensorSpec((h, hd, d), ("heads", "qkv", "embed")),
    }


# The scan runs head-major: the carries are (H, B, hd), the z|i|f
# preactivations one (S, H, B, 3hd) tensor, so each step's recurrent
# product and its gate sum are one ``baddbmm`` and the output gate, which
# does not recur, is taken for every step at once.

def _head_major(preacts, state):
    pz, pi, pf, po = preacts
    pre = torch.cat([pz, pi, pf], dim=-1).permute(0, 2, 1, 3).contiguous()
    o = torch.sigmoid(po).permute(0, 2, 1, 3)
    return pre, o, tuple(x.transpose(0, 1).contiguous() for x in state)


def _step(r32, rdt, carry, pre_t, o_t):
    """One sLSTM step. carry = (h, c, n), each (H,B,hd) f32; pre_t the
    step's z|i|f preactivations (H,B,3hd) f32 and o_t its output gate;
    ``r32`` is the recurrent matrix read as f32 and ``rdt`` its dtype, to
    which ``h`` is rounded before the product."""
    hp, cp, np_ = carry
    hd = hp.shape[-1]
    a = torch.baddbmm(pre_t, _up(hp, rdt), r32)              # pre + h @ r
    z = torch.tanh(a[..., :hd])
    i = torch.exp(torch.clamp(a[..., hd:2 * hd], max=10.0))
    f = torch.sigmoid(a[..., 2 * hd:])
    c = f * cp + i * z
    n = f * np_ + i
    hh = o_t * c / torch.clamp(n, min=1.0)
    return (hh, c, n), hh


def slstm_scan_plain(r, preacts, state):
    """The recurrence as a loop of torch ops, differentiated by torch's
    autograd. preacts = (pz, pi, pf, po), each (S,B,H,hd) f32; state =
    (h, c, n), each (B,H,hd) f32. Returns ((h, c, n), ys (S,B,H,hd))."""
    pre, o, carry = _head_major(preacts, state)
    r32, ys = r.float(), []
    for t in range(pre.shape[0]):
        carry, hh = _step(r32, r.dtype, carry, pre[t], o[t])
        ys.append(hh)
    return (tuple(x.transpose(0, 1) for x in carry),
            torch.stack(ys).permute(0, 2, 1, 3))


class SlstmScan(torch.autograd.Function):
    """The sLSTM scan with the reference's hand-written backward
    (``ssm.py:313-377``): the forward is recomputed (remat), one reverse
    loop gives the per-step cotangents, and the weight gradient is one
    einsum over the stacked sequence after the loop. Its expressions are
    the reference's, evaluated in the same order."""

    @staticmethod
    def forward(ctx, r, pz, pi, pf, po, h0, c0, n0):
        with torch.no_grad():
            (hf, cf, nf), ys = slstm_scan_plain(r, (pz, pi, pf, po), (h0, c0, n0))
        ctx.save_for_backward(r, pz, pi, pf, po, h0, c0, n0)
        return hf, cf, nf, ys

    @staticmethod
    def backward(ctx, d_hf, d_cf, d_nf, d_ys):
        r, pz, pi, pf, po, h0, c0, n0 = ctx.saved_tensors
        r32, rdt = r.float(), r.dtype
        r32_t = r32.transpose(1, 2)                                # (H,3hd,hd)
        with torch.no_grad():
            pre, o, carry = _head_major((pz, pi, pf, po), (h0, c0, n0))
            hd = o.shape[-1]
            # re-run the forward, keeping each step's incoming state [remat]
            prevs = []
            for t in range(pre.shape[0]):
                prevs.append(carry)
                carry, _ = _step(r32, rdt, carry, pre[t], o[t])
            hps, cps, nps = (torch.stack(x) for x in zip(*prevs))  # (S,H,B,hd)
            # the step-internal values of every step at once
            a = pre + torch.matmul(_up(hps, rdt), r32)
            pre_i = a[..., hd:2 * hd]
            z = torch.tanh(a[..., :hd])
            i = torch.exp(torch.clamp(pre_i, max=10.0))
            f = torch.sigmoid(a[..., 2 * hd:])
            c = f * cps + i * z
            n = f * nps + i
            nmax = torch.clamp(n, min=1.0)
            nn = nmax * nmax
            one_m_zz, one_m_f = 1.0 - z * z, 1.0 - f
            n_live, i_live = n > 1.0, pre_i < 10.0

            d_ys = d_ys.permute(0, 2, 1, 3).contiguous()
            d_h, d_c, d_n = (x.transpose(0, 1) for x in (d_hf, d_cf, d_nf))
            d_hs = []
            d_recs = torch.empty(a.shape, dtype=F32, device=a.device)
            zero = torch.zeros((), dtype=F32, device=a.device)
            for t in range(pre.shape[0] - 1, -1, -1):
                # d_ys[t] adds to the h-cotangent entering step t's backward
                d_h = d_h + d_ys[t]
                d_hs.append(d_h)
                # hh = o * c / nmax; d_n += -d_h o c / nmax² where n > 1
                d_c = d_c + d_h * o[t] / nmax[t]
                d_n = d_n - torch.where(n_live[t], d_h * o[t] * c[t] / nn[t], zero)
                # c = f c_p + i z ; n = f n_p + i
                d_f = d_c * cps[t] + d_n * nps[t]
                d_i = d_c * z[t] + d_n
                d_z = d_c * i[t]
                # gates
                torch.cat([d_z * one_m_zz[t],
                           torch.where(i_live[t], d_i * i[t], zero),
                           d_f * f[t] * one_m_f[t]], dim=-1, out=d_recs[t])
                d_h = torch.bmm(_up(d_recs[t], rdt), r32_t)
                d_c, d_n = d_c * f[t], d_n * f[t]
            d_hs = torch.stack(d_hs[::-1])
            d_po = d_hs * c / nmax * o * (1.0 - o)
            # weight gradient: ONE einsum over the stacked sequence
            d_r = torch.einsum("shbk,shbl->hkl", hps, d_recs).to(rdt)
            d_pre = d_recs.permute(0, 2, 1, 3)
            grads = (d_pre[..., :hd], d_pre[..., hd:2 * hd], d_pre[..., 2 * hd:],
                     d_po.permute(0, 2, 1, 3), *(x.transpose(0, 1) for x in (d_h, d_c, d_n)))
        return (d_r, *grads)


def slstm_scan(r, preacts, state):
    """The sLSTM scan with the hand-written backward; the signature of
    ``slstm_scan_plain``."""
    hf, cf, nf, ys = SlstmScan.apply(r, *preacts, *state)
    return (hf, cf, nf), ys


def slstm(p: dict, cfg: ModelConfig, h_in: torch.Tensor, *, state=None):
    """sLSTM with head-local recurrence. state = (h, c, n) each (B,H,hd).
    Sequential over time by construction."""
    b, s, d = h_in.shape
    nh, hd = cfg.n_heads, cfg.resolved_head_dim
    dt = h_in.dtype
    pre = tuple(torch.einsum("bsd,dhk->sbhk", h_in, p[w].to(dt)).float()
                for w in ("wz", "wi", "wf", "wo"))
    r = p["r"].to(dt)  # bf16 recurrence matmul, f32 accumulation

    if state is None:
        h0 = torch.zeros((b, nh, hd), dtype=F32, device=h_in.device)
        state = (h0, h0, h0 + 1.0)

    (hf, cf, nf), ys = slstm_scan(r, pre, state)
    y = ys.transpose(0, 1).to(dt)                              # (B,S,H,hd)
    out = torch.einsum("bshk,hkd->bsd", y, p["out"].to(dt))
    return out, (hf, cf, nf)
