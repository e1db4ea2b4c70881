"""Float64 oracles that hold the kernels to fp32 accuracy on real-valued data.

On integer-valued data every kernel equals its plain version bit for bit,
but so would a kernel that rounded its inputs to TF32 or bf16: integers in
[0, 255] are exact in both. These oracles compute the kernels' functions in
float64 and bound, for each query, the error that an fp32 evaluation may
make with one rounding per product and per sum, in any order:

    |fl(||p||^2 - 2 p.q) - (||p||^2 - 2 p.q)|
        <= g_d * (||p||^2 + 2 * sum_i |p_i q_i|) + u * |||p||^2 - 2 p.q|

with u = 2^-24 and g_d = d u / (1 - d u) (the dot-product bound of Higham,
*Accuracy and Stability of Numerical Algorithms*, eq. 3.5, for each sum;
to first order in u). The i-th smallest of a set of values moves by no more
than the largest move of any one value, so a right fp32 kernel's sorted
distances lie within the bound of the oracle's. TF32, which rounds each
product's inputs to 11 significant bits, misses it several times over.
``attention_f64`` does the same for flash attention (its bound is in its
docstring), and ``attention_bf16_tol`` bounds the gap between a bf16
attention kernel and its plain version; ``segsum_f64`` for the segment sum
of GIN's message passing.

These run on any device; they are checks, not part of the search path.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.distance import topk_lex
from repro_torch.kernels.segsum.ref import segsum_ref

U32 = 2.0**-24  # unit roundoff of fp32


def gamma(n: int) -> float:
    """Higham's gamma_n for fp32: the relative error bound of an n-term sum."""
    return n * U32 / (1.0 - n * U32)


def topk_f64(points, point_leaves, queries, query_leaves, k: int, *,
             chunk_rows: int | None = None):
    """The l2topk plain version in float64, with each query's fp32 bound.

    Returns ``(dists (Q,k) f64, rows (Q,k) int64, tol (Q,) f64)``: partial
    distances ``||p||^2 - 2 p.q`` of same-leaf points, ascending by
    (distance, row), ``inf``/``-1`` where fewer than ``k`` match; ``tol`` is
    the largest fp32 bound over the query's same-leaf points. ``chunk_rows``
    scans the points in chunks, folding by (distance, row), for shards
    whose (P, Q) matrix would not fit.
    """
    P, d = points.shape
    Q, dev = queries.shape[0], points.device
    q = queries.double()
    qa = q.abs()
    g = gamma(d)
    best_d = torch.full((Q, k), math.inf, dtype=torch.float64, device=dev)
    best_r = torch.full((Q, k), -1, dtype=torch.int64, device=dev)
    tol = torch.zeros(Q, dtype=torch.float64, device=dev)
    step = chunk_rows or P
    for s in range(0, P, step):
        p = points[s:s + step].double()
        pn = (p * p).sum(-1)
        d2 = pn[:, None] - 2.0 * (p @ q.T)
        match = point_leaves[s:s + step, None] == query_leaves[None, :]
        bound = g * (pn[:, None] + 2.0 * (p.abs() @ qa.T)) + U32 * d2.abs()
        tol = torch.maximum(tol, torch.where(match, bound, 0.0).amax(0))
        vals, sel = topk_lex(torch.where(match, d2, math.inf).T, min(k, p.shape[0]))
        rows = torch.where(torch.isfinite(vals), sel + s, -1)
        # running entries are the earlier rows, so they win distance ties
        best_d, pick = topk_lex(torch.cat([best_d, vals], 1), k)
        best_r = torch.gather(torch.cat([best_r, rows], 1), 1, pick)
    return best_d, best_r, tol


def pair_partial_f64(points, queries, rows):
    """Float64 ``||p||^2 - 2 p.q`` of each query's listed point rows
    ``(Q, k)``; ``inf`` where the row is -1."""
    p = points[rows.clamp(min=0)].double()
    v = (p * p).sum(-1) - 2.0 * (p * queries.double()[:, None, :]).sum(-1)
    return torch.where(rows >= 0, v, math.inf)


def topk_error_ratio(dists, rows, points, queries, exact, tol) -> float:
    """Largest |error| / bound of a (Q, k) k-NN table of partial distances
    whose ``rows`` index ``points``: each distance against the oracle's
    sorted list ``exact`` and against the float64 distance of the row it
    names. ``inf`` when the two disagree on which entries exist."""
    fin = torch.isfinite(exact)
    if not torch.equal(torch.isfinite(dists), fin):
        return math.inf
    if not fin.any():
        return 0.0
    t = tol[:, None].expand_as(exact)[fin]
    got = dists.double()[fin]
    pair = pair_partial_f64(points, queries, rows.long())[fin]
    err = torch.maximum((got - exact[fin]).abs(), (got - pair).abs())
    return float((err / t).max())


def nearest_error_ratio(idx, dist, x, centroids) -> float:
    """Largest |error| / bound of an l2nn result ``(idx (N,), dist (N,))``.

    ``dist`` is held against the float64 ``min_c(||c||^2 - 2 x.c) + ||x||^2``
    within the fp32 bound of the partials' minimum, of ``||x||^2`` and of
    the final sum; the chosen centroid's float64 partial must lie within
    twice the partials' bound of the minimum (a near-tie may go either way).
    """
    xd, c = x.double(), centroids.double()
    cn, xn = (c * c).sum(-1), (xd * xd).sum(-1)
    partial = cn[None, :] - 2.0 * (xd @ c.T)
    g = gamma(x.shape[1])
    pb = (g * (cn[None, :] + 2.0 * (xd.abs() @ c.abs().T))
          + U32 * partial.abs()).amax(1)
    best = partial.min(1).values
    exact = best + xn
    tol = pb + g * xn + U32 * exact.abs()
    chosen = partial.gather(1, idx.long()[:, None])[:, 0]
    r1 = (dist.double() - exact).abs() / tol
    r2 = (chosen - best) / (2.0 * pb)
    return float(torch.maximum(r1, r2).max())


def ties_within_bound(x, centroids, idx_a, idx_b) -> torch.Tensor:
    """(N,) bool: whether centroids ``idx_a`` and ``idx_b`` are each a
    right fp32 nearest centroid of their row -- equal, or their float64
    partials ``||c||^2 - 2 x.c`` within twice the row's fp32 bound of each
    other (a near-tie that two fp32 evaluations may break either way)."""
    xd, c = x.double(), centroids.double()
    cn = (c * c).sum(-1)
    partial = cn[None, :] - 2.0 * (xd @ c.T)
    g = gamma(x.shape[1])
    pb = (g * (cn[None, :] + 2.0 * (xd.abs() @ c.abs().T))
          + U32 * partial.abs()).amax(1)
    pa = partial.gather(1, idx_a.long()[:, None])[:, 0]
    pbb = partial.gather(1, idx_b.long()[:, None])[:, 0]
    return (idx_a == idx_b) | ((pa - pbb).abs() <= 2.0 * pb)


def attention_f64(q, k, v, *, window: int = -1, rows: int = 8):
    """The flash-attention plain version in float64, with an fp32 bound.

    Returns ``(out (B,Sq,Hq,hd) f64, tol (B,Sq,Hq,hd) f64)``. ``tol`` bounds,
    to first order in u, the error of any fp32 evaluation of
    ``kernels/flashattn/ref.py`` on these fp32 inputs that sums in any order
    and rescales its running sums at most once per 16 keys (an online
    softmax; K6 rescales once per 64). With exact scores s_j, weights
    w_j = softmax(s)_j and output o = sum_j w_j v_j, a relative error eps_j
    in the j-th unnormalised
    weight moves o by sum_j w_j eps_j (v_j - o); the two sums of the n
    unmasked terms (denominator and accumulator) and the final division add
    (2 gamma_n + u) sum_j w_j |v_j|:

        eps_j = scale gamma_hd sum_d |q_d k_jd|      (the dot product)
              + u (2 |s_j| + max_k |s_k|)             (scaling; s - m)
              + u (4 + 6 ceil(Skv / 16))              (exp within 2 ulp; each
                                                      rescale's exp, product
                                                      and subtraction)

    Masked keys add exact zeros. TF32, which rounds every product's inputs
    to 11 significant bits, breaks the bound where attention rests on a few
    keys (its errors cancel where it spreads over many). ``rows`` query
    rows are expanded against every key at a time.
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    qg = q.double().reshape(B, Sq, Hkv, G, hd)
    kd, vd = k.double(), v.double()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kd) * scale
    a = torch.einsum("bqkgh,bskh->bkgqs", qg.abs(), kd.abs()) * scale
    dist = (torch.arange(Sq, device=q.device) + (Skv - Sq))[:, None] - torch.arange(
        Skv, device=q.device)[None, :]
    mask = dist >= 0
    if window > 0:
        mask &= dist < window
    w = torch.softmax(torch.where(mask, s, -math.inf), dim=-1)
    out = torch.einsum("bkgqs,bskh->bkgqh", w, vd)
    s = torch.where(mask, s, 0.0)
    eps = (gamma(hd) * a + U32 * (2.0 * s.abs() + s.abs().amax(-1, keepdim=True))
           + U32 * (4.0 + 6.0 * math.ceil(Skv / 16)))
    we = w * eps  # masked keys have w = 0
    del s, a, eps
    vt = vd.permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, Skv, hd)
    spread = torch.empty_like(out)
    for i in range(0, Sq, rows):
        o_i = out[:, :, :, i:i + rows, None, :]  # (B, Hkv, G, r, 1, hd)
        spread[:, :, :, i:i + rows] = torch.einsum(
            "bkgqs,bkgqsh->bkgqh", we[:, :, :, i:i + rows],
            (vt[:, :, :, None] - o_i).abs())
    n = mask.sum(-1).double()  # (Sq,) unmasked keys per row
    g_n = n * U32 / (1.0 - n * U32)
    absv = torch.einsum("bkgqs,bskh->bkgqh", w, vd.abs())
    tol = spread + (2.0 * g_n[:, None] + U32) * absv
    perm = (0, 3, 1, 2, 4)
    return (out.permute(*perm).reshape(B, Sq, Hq, hd),
            tol.permute(*perm).reshape(B, Sq, Hq, hd))


def attention_error_ratio(out, exact, tol) -> float:
    """Largest |out - exact| / tol over an attention output."""
    return float(((out.double() - exact).abs() / tol).max())


U_BF16 = 2.0**-8  # unit roundoff of bf16 (8 significant bits)


def attention_bf16_tol(q, k, v, *, window: int = -1):
    """Per-element tolerance ``(B, Sq, Hq, hd)`` between two bf16 attention
    outputs on the same bf16 inputs: a kernel that keeps its weights in fp32,
    and the plain version, which rounds them to bf16 before the PV product.
    With w, o the exact weights and output (float64 here):

        |kernel - plain| <= u_b sum_j w_j |v_j|      (the plain weights' rounding)
                          + 2 u_b |o|                 (each output's rounding)
                          + 2^-12 sum_j w_j |v_j|     (fp32 evaluation order)

    The last term covers the two fp32 evaluations, which ``attention_f64``'s
    bound holds to a small fraction of 2^-12 sum_j w_j |v_j|.
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    s = torch.einsum("bqkgh,bskh->bkgqs", q.double().reshape(B, Sq, Hkv, G, hd),
                     k.double()) * scale
    dist = (torch.arange(Sq, device=q.device) + (Skv - Sq))[:, None] - torch.arange(
        Skv, device=q.device)[None, :]
    mask = dist >= 0
    if window > 0:
        mask &= dist < window
    w = torch.softmax(torch.where(mask, s, -math.inf), dim=-1)
    del s
    vd = v.double()
    o = torch.einsum("bkgqs,bskh->bqkgh", w, vd).reshape(B, Sq, Hq, hd)
    absv = torch.einsum("bkgqs,bskh->bqkgh", w, vd.abs()).reshape(B, Sq, Hq, hd)
    return (U_BF16 + 2.0**-12) * absv + 2.0 * U_BF16 * o.abs()


def _gamma_t(n: torch.Tensor) -> torch.Tensor:
    """Higham's gamma_n of fp32 for a tensor of term counts."""
    n = n.double()
    return n * U32 / (1.0 - n * U32)


def attention_grads_f64(q, k, v, dout, *, window: int = -1, rows: int = 256):
    """The float64 gradient of flash attention, with an fp32 bound and a
    bf16 tolerance for each of ``dq``, ``dk``, ``dv``.

    Returns ``(grads, tol_fp32, tol_bf16)``, each a ``(dq, dk, dv)`` triple
    of float64 tensors shaped like q, k and v. ``grads`` is the exact
    gradient of ``ref.flash_attention_ref`` at (q, k, v) for the output
    gradient ``dout`` (their values taken as exact). ``tol_fp32`` bounds, to
    first order in u = 2^-24, the error of any fp32 evaluation of the
    backward's formulas (``ref.flash_attention_bwd_ref``) from these fp32
    inputs, the forward's fp32 ``out`` and ``lse``, summing in any order.
    With exact scores s_ij, weights P_ij, output o_i, lse_i, M_i = max_j
    |s_ij| and n_i unmasked keys of row i:

      e_s_ij  = scale gamma_hd sum_d |q_id k_jd| + u |s_ij|   (the score)
      eps_ij  = e_s_ij + sum_k P_ik e_s_ik                     (s - lse moves)
              + u (|s_ij| + 4 M_i + 3 |lse_i|)                 (subtractions, log)
              + gamma_{n_i} + u (6 + 6 ceil(Skv / 16))         (lse's sum, exps,
                                                               rescales)
              : the relative error of P_ij = exp(s - lse)
      e_D_i   = gamma_hd sum_d |dout_id o_id| + sum_d |dout_id| tol_o_id
              (tol_o: ``attention_f64``'s bound on the forward's out)
      e_dS_ij = P_ij ((eps_ij + 2u) |dP_ij - D_i|
                      + gamma_hd sum_d |dout_id v_jd| + e_D_i)
      tol_dq_i = scale sum_j (e_dS_ij + gamma_{n_i+1} |dS_ij|) |k_j| + u |dq_i|
      tol_dk_j = scale sum_i (e_dS_ij + gamma_{N_j+1} |dS_ij|) |q_i| + u |dk_j|
      tol_dv_j = sum_i P_ij |dout_i| (eps_ij + gamma_{N_j+1})

    where i runs over the rows of key j's group (its G query heads) that see
    it, N_j of them. The counts are per row and per key, so the sums over
    few terms (a causal run's first rows, its last keys) keep a tight bound,
    which TF32's rounding of the products' inputs breaks; over thousands of
    terms TF32's errors cancel inside it, as they do in the forward.

    ``tol_bf16`` bounds the error of such an evaluation from bf16 inputs
    whose ``out`` was rounded to bf16 once (the forward's output) and whose
    gradients are each rounded to bf16 once: u_b |g| (u_b = 2^-8) plus
    (1 + u_b) times ``tol_fp32`` and the rounding of out inside D, |dD_i| <=
    u_b sum_d |dout_id o_id|, carried through dS = P (dP - D) into dq and dk
    (dv does not read D). ``rows`` query rows are expanded against every
    key at a time.
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    dist = (torch.arange(Sq, device=dev) + (Skv - Sq))[:, None] - torch.arange(
        Skv, device=dev)[None, :]
    mask = dist >= 0
    if window > 0:
        mask &= dist < window
    # the forward's exact output and its fp32 bound, (B, Hkv, G, Sq, hd)
    o_all, tol_all = (t.reshape(B, Sq, Hkv, G, hd).permute(0, 2, 3, 1, 4)
                      for t in attention_f64(q, k, v, window=window))
    kd, vd = k.double(), v.double()
    ka, va = kd.abs(), vd.abs()
    g_hd = gamma(hd)
    fixed = U32 * (6.0 + 6.0 * math.ceil(Skv / 16))
    dq = torch.empty((B, Sq, Hkv, G, hd), dtype=torch.float64, device=dev)
    tq, bq = torch.empty_like(dq), torch.empty_like(dq)
    dk, dv = torch.zeros_like(kd), torch.zeros_like(vd)
    a_dk, b_dk, x_dk = (torch.zeros_like(kd) for _ in range(3))
    a_dv, b_dv = torch.zeros_like(vd), torch.zeros_like(vd)
    for i0 in range(0, Sq, rows):
        i1 = min(Sq, i0 + rows)
        m = mask[i0:i1]
        qg = q[:, i0:i1].double().reshape(B, i1 - i0, Hkv, G, hd)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kd) * scale
        a = torch.einsum("bqkgh,bskh->bkgqs", qg.abs(), ka) * scale
        w = torch.softmax(torch.where(m, s, -math.inf), dim=-1)
        lse = torch.logsumexp(torch.where(m, s, -math.inf), -1, keepdim=True)
        s = torch.where(m, s, 0.0)
        sa = s.abs()
        big = sa.amax(-1, keepdim=True)
        n = m.sum(-1).double()[:, None]  # (r, 1) unmasked keys a row
        o, tol_o = o_all[:, :, :, i0:i1], tol_all[:, :, :, i0:i1]
        gg = dout[:, i0:i1].double().reshape(B, i1 - i0, Hkv, G, hd)
        ggo = gg.permute(0, 2, 3, 1, 4)  # (B, Hkv, G, r, hd)
        dp = torch.einsum("bqkgh,bskh->bkgqs", gg, vd)
        adp = torch.einsum("bqkgh,bskh->bkgqs", gg.abs(), va)
        d = (ggo * o).sum(-1, keepdim=True)
        e_d = g_hd * (ggo * o).abs().sum(-1, keepdim=True) + (
            ggo.abs() * tol_o).sum(-1, keepdim=True)
        d_b = U_BF16 * (ggo * o).abs().sum(-1, keepdim=True)  # out's bf16 rounding
        e_s = torch.where(m, g_hd * a + U32 * sa, 0.0)
        eps = (e_s + (w * e_s).sum(-1, keepdim=True)
               + U32 * (sa + 4.0 * big + 3.0 * lse.abs()) + _gamma_t(n) + fixed)
        del a, e_s
        ds = w * (dp - d)
        e_ds = w * ((eps + 2.0 * U32) * (dp - d).abs() + g_hd * adp + e_d)
        del adp
        dsa = ds.abs()
        pdb = w * d_b
        dq[:, i0:i1] = (torch.einsum("bkgqs,bskh->bkgqh", ds, kd) * scale).permute(
            0, 3, 1, 2, 4)
        tq[:, i0:i1] = (torch.einsum("bkgqs,bskh->bkgqh", e_ds + _gamma_t(n + 1) * dsa,
                                     ka) * scale).permute(0, 3, 1, 2, 4)
        bq[:, i0:i1] = (torch.einsum("bkgqs,bskh->bkgqh", pdb, ka) * scale).permute(
            0, 3, 1, 2, 4)
        qa = qg.abs()
        dk += torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * scale
        a_dk += torch.einsum("bkgqs,bqkgh->bskh", e_ds, qa) * scale
        b_dk += torch.einsum("bkgqs,bqkgh->bskh", dsa, qa) * scale
        x_dk += torch.einsum("bkgqs,bqkgh->bskh", pdb, qa) * scale
        dv += torch.einsum("bkgqs,bqkgh->bskh", w, gg)
        a_dv += torch.einsum("bkgqs,bqkgh->bskh", w * eps, gg.abs())
        b_dv += torch.einsum("bkgqs,bqkgh->bskh", w, gg.abs())
        del s, w, ds, e_ds, dsa, pdb, dp, eps
    del o_all, tol_all
    # N_j: the rows of key j's group that see it
    n_key = (mask.sum(0).double() * G)[None, :, None, None]
    g_key = _gamma_t(n_key + 1)
    tk = a_dk + g_key * b_dk + U32 * dk.abs()
    tv = a_dv + g_key * b_dv
    dq = dq.reshape(B, Sq, Hq, hd)
    tq = (tq.reshape(B, Sq, Hq, hd) + U32 * dq.abs())
    bq = bq.reshape(B, Sq, Hq, hd)
    w16 = 1.0 + U_BF16  # the final rounding also scales the fp32 error
    tol16 = (w16 * (tq + bq) + U_BF16 * dq.abs(), w16 * (tk + x_dk) + U_BF16 * dk.abs(),
             w16 * tv + U_BF16 * dv.abs())
    return (dq, dk, dv), (tq, tk, tv), tol16


def grads_error_ratio(got, exact, tol) -> float:
    """Largest |got - exact| / tol over the three gradients (triples); an
    exact entry counts 0 (a key no query row sees has gradient and bound
    0)."""
    out = 0.0
    for g, e, t in zip(got, exact, tol):
        err = (g.double() - e).abs()
        out = max(out, float(torch.where(err == 0, 0.0, err / t).max()))
    return out


def segsum_f64(h, csr):
    """The segsum plain version in float64 over ``csr`` (a
    ``kernels.segsum.SegmentCSR``), with each output's fp32 bound:
    ``(exact (n_rows, d) f64, tol (n_rows, d) f64)``. A row of n edges
    sums n rounded products in some order, so its fp32 value lies within
    gamma_{n+1} * sum |w h| of the exact sum (each product's rounding is
    one more term of the chain)."""
    exact = segsum_ref(h.double(), csr.indptr, csr.cols, csr.w.double())
    mag = segsum_ref(h.double().abs(), csr.indptr, csr.cols, csr.w.double().abs())
    n = (csr.indptr[1:] - csr.indptr[:-1]).double() + 1
    return exact, (n * U32 / (1 - n * U32))[:, None] * mag


def segsum_error_ratio(out, exact, tol) -> float:
    """max |out - exact| / tol; an output whose bound is 0 (a row with no
    edge, or only zero terms) must be exact, else the ratio is inf."""
    err = (out.double() - exact).abs()
    zero = tol == 0
    if bool((err[zero] > 0).any()):
        return math.inf
    return float((err[~zero] / tol[~zero]).max()) if bool((~zero).any()) else 0.0
