"""The fp32 SSD tensor-core kernels' arithmetic in torch, on the CPU
(``ssd_chunk_tf32``, ``ssd_chunk_tf32_tiled`` and ``ssd_carry_tf32`` in
``csrc/ssd.cu``, ``ssd_chunk_bwd_tf32``, ``ssd_chunk_bwd_tf32_tiled`` and
``ssd_carry_bwd_tf32`` in ``csrc/ssd_bwd.cu``), shared by
``test_torch_ssd.py`` and ``test_torch_ssd_bwd.py``.

Every product of the four kernels is taken on ``mma.sync`` m16n8k8 with
TF32 operands: each fp32 operand split into hi = its TF32 rounding (to
nearest, ties away from zero) and lo = what is left (which the tensor
cores read cut to TF32), and each product taken as hi·hi + hi·lo + lo·hi
(:func:`tf32_mm`), k8 step by k8 step in order, each step's k in the
slot order the kernel feeds (``NATURAL`` or ``PERMUTED``).  The sums are
torch's fp32 sums, not the tensor cores' (whose accumulation over a step
cuts rather than rounds): a fault of that kind shows only on the card.
"""
import torch

# The k of each of the 8 slots of a k8 step: slots c and c + 4 hold k = c
# and c + 4 (an operand read K-major), or k = 2c and 2c + 1 (an
# accumulator's columns 2c, 2c + 1 read as an A fragment, and the B rows
# that meet them).
NATURAL = (0, 1, 2, 3, 4, 5, 6, 7)
PERMUTED = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_rna(x):
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as the kernels' ``split_tf32`` rounds it (half a TF32
    step added to the bits, the 13 bits below cleared)."""
    x = x.float()
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    return torch.where(torch.isnan(x), x, r.view(torch.float32))


def tf32_cut(x):
    """fp32 ``x`` as the tensor cores read a .tf32 operand: its 13 lowest
    bits dropped."""
    u = x.float().contiguous().view(torch.int32)
    return (u & -0x2000).view(torch.float32)


def tf32_mm(a, b, slots=NATURAL, terms=3, init=None):
    """``init`` + a @ b (a [..., M, K], b [..., K, N], K a multiple of 8)
    as the kernels take it: per k8 step in order, the step's k in
    ``slots`` order, hi·hi, then (``terms`` 3) hi·lo, then (``terms`` >= 2)
    lo·hi added to the running sum.  ``terms`` 1 is plain TF32, 2 splits
    only ``a``."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_cut(a - ah), tf32_cut(b - bh)
    K = a.shape[-1]
    out = torch.zeros(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
                      + (a.shape[-2], b.shape[-1])) if init is None \
        else init.float()
    order = torch.tensor(slots)
    for k0 in range(0, K, 8):
        idx = k0 + order
        pa = [ah[..., idx], al[..., idx]]
        pb = [bh[..., idx, :], bl[..., idx, :]]
        out = out + pa[0] @ pb[0]
        if terms >= 3:
            out = out + pa[0] @ pb[1]
        if terms >= 2:
            out = out + pa[1] @ pb[0]
    return out


def emulate_tf32_chunks(x, dt, cum, Bm, Cm, chunk, terms=3):
    """``ssd_chunk_tf32``'s arithmetic: C·Bᵀ (natural slots over n); W =
    (C·Bᵀ) ∘ exp(cum_i − cum_j) ∘ dt_j in fp32 (0 above the diagonal);
    y = W·x and the state (B ∘ dec_end)ᵀ·x, dec_end_j = exp(cum_last −
    cum_j) dt_j, B scaled as it is read (permuted slots over j).  Returns
    (y_intra [B,L,H,P], states [B,nc,H,N,P]) as ``ssd_chunks_ref``."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = L // chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(Bsz, nc, chunk, H, P).permute(0, 1, 3, 2, 4)
    dtc = dt.to(f32).reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)
    cumc = cum.to(f32).reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)
    Bc = Bm.to(f32).reshape(Bsz, nc, chunk, N)
    Cc = Cm.to(f32).reshape(Bsz, nc, chunk, N)
    cb = tf32_mm(Cc, Bc.transpose(-1, -2), NATURAL, terms)   # [b,c,i,j]
    iota = torch.arange(chunk)
    causal = iota[:, None] >= iota[None, :]
    seg = cumc[..., :, None] - cumc[..., None, :]            # [b,c,h,i,j]
    w = torch.where(causal, cb[:, :, None] * torch.exp(
        torch.where(causal, seg, 0.0)) * dtc[..., None, :], 0.0)
    y = tf32_mm(w, xc, PERMUTED, terms)                      # [b,c,h,i,p]
    dec = torch.exp(cumc[..., -1:] - cumc) * dtc             # [b,c,h,j]
    bd = Bc[:, :, None] * dec[..., None]                     # [b,c,h,j,n]
    st = tf32_mm(bd.transpose(-1, -2), xc, PERMUTED, terms)  # [b,c,h,n,p]
    return y.permute(0, 1, 3, 2, 4).reshape(Bsz, L, H, P), st


def emulate_tf32_chunks_tiled(x, dt, cum, Bm, Cm, chunk, terms=3, rows=64):
    """``ssd_chunk_tf32_tiled``'s walk over tiles of ``rows`` rows: per
    row block I, C_I·B_Jᵀ for J <= I over n in pieces of 64 columns, each
    piece's k8 steps continuing the last's sum (natural slots); W_IJ built
    from it in fp32 (0 above the diagonal of J = I) and y_I summed over J
    in order in one running sum (permuted slots over j); the state summed
    over J in order, B ∘ dec_end scaled as read (permuted slots).  Returns
    (y_intra [B,L,H,P], states [B,nc,H,N,P]) as ``ssd_chunks_ref``."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    nc, nb = L // chunk, chunk // rows
    f32 = torch.float32
    xc = x.to(f32).reshape(Bsz, nc, chunk, H, P).permute(0, 1, 3, 2, 4)
    dtc = dt.to(f32).reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)
    cumc = cum.to(f32).reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)
    Bc = Bm.to(f32).reshape(Bsz, nc, chunk, N)
    Cc = Cm.to(f32).reshape(Bsz, nc, chunk, N)
    blocks = [slice(k * rows, (k + 1) * rows) for k in range(nb)]
    iota = torch.arange(rows)
    y = torch.zeros_like(xc)
    for I, i in enumerate(blocks):
        acc = None
        for J, j in enumerate(blocks[:I + 1]):
            cb = None
            for n0 in range(0, N, 64):
                cb = tf32_mm(Cc[:, :, i, n0:n0 + 64],
                             Bc[:, :, j, n0:n0 + 64].transpose(-1, -2),
                             NATURAL, terms, init=cb)         # [b,c,i,j]
            causal = (iota[:, None] >= iota[None, :]) if I == J else \
                torch.ones((rows, rows), dtype=torch.bool)
            seg = cumc[..., i, None] - cumc[..., None, j]     # [b,c,h,i,j]
            w = torch.where(causal, cb[:, :, None] * torch.exp(
                torch.where(causal, seg, 0.0)) * dtc[..., None, j], 0.0)
            acc = tf32_mm(w, xc[..., j, :], PERMUTED, terms, init=acc)
        y[..., i, :] = acc
    dec = torch.exp(cumc[..., -1:] - cumc) * dtc             # [b,c,h,j]
    bd = Bc[:, :, None] * dec[..., None]                     # [b,c,h,j,n]
    st = None
    for j in blocks:
        st = tf32_mm(bd[..., j, :].transpose(-1, -2), xc[..., j, :],
                     PERMUTED, terms, init=st)               # [b,c,h,n,p]
    return y.permute(0, 1, 3, 2, 4).reshape(Bsz, L, H, P), st


def emulate_tf32_chunk_bwd(x, dt, cum, Bm, Cm, dy, g, h_prev, chunk,
                           heads_per_group, terms=3):
    """``ssd_chunk_bwd_tf32``'s arithmetic, as ``ssd_chunk_bwd_ref``'s
    outputs: (C·Bᵀ)ᵀ = B·Cᵀ and B·g over n with B's columns in permuted
    slots; dWᵀ = x·dyᵀ, x·gᵀ and dy·h_prevᵀ over p in natural slots;
    dx's intra term (K∘dt)ᵀ·dy, K∘dt built from (C·Bᵀ)ᵀ in fp32, in
    permuted slots added onto the state term d_j (B·g)_j; the group's
    summed dW∘E∘dt against C and B in natural slots, each summed from zero
    and added to the running dB, dC; row and column sums in fp32."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    nc, G = L // chunk, heads_per_group
    f32 = torch.float32

    def heads(t, width):          # [B,L,H,w] -> [b,c,h,Q,w]
        return t.to(f32).reshape(Bsz, nc, chunk, H, width).permute(
            0, 1, 3, 2, 4)
    xc, dyc = heads(x, P), heads(dy, P)
    dtc = dt.to(f32).reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)
    cumc = cum.to(f32).reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)
    Bc = Bm.to(f32).reshape(Bsz, nc, chunk, N)
    Cc = Cm.to(f32).reshape(Bsz, nc, chunk, N)
    gc, hc = g.to(f32), h_prev.to(f32)                      # [b,c,h,n,p]
    cbt = tf32_mm(Bc, Cc.transpose(-1, -2), PERMUTED, terms)  # [b,c,j,i]
    iota = torch.arange(chunk)
    causal_ji = iota[None, :] >= iota[:, None]               # i >= j
    seg = cumc[..., None, :] - cumc[..., :, None]            # [b,c,h,j,i]
    ex = torch.where(causal_ji, torch.exp(torch.where(causal_ji, seg, 0.0)),
                     0.0)
    dt_j = dtc[..., :, None]
    kv = cbt[:, :, None] * ex                                # Kᵀ [j, i]
    dwt = tf32_mm(xc, dyc.transpose(-1, -2), NATURAL, terms)  # dWᵀ [j, i]
    dec = torch.exp(cumc[..., -1:] - cumc)
    d = dec * dtc                                            # [b,c,h,j]
    bg = tf32_mm(Bc[:, :, None], gc, PERMUTED, terms)        # [b,c,h,j,p]
    ured = (xc * bg).sum(-1)
    dx = tf32_mm(kv * dt_j, dyc, PERMUTED, terms, init=d[..., None] * bg)
    v = dwt * kv
    colv = v.sum(-1)                                         # Σ_i V_ij
    rowt = (v * dt_j).sum(-2)                                # Σ_j T_ij
    gx = tf32_mm(xc, gc.transpose(-1, -2), NATURAL, terms)   # [b,c,h,j,n]
    dyh = tf32_mm(dyc, hc.transpose(-1, -2), NATURAL, terms)  # [b,c,h,i,n]
    ecum = torch.exp(cumc)
    inter = ecum * (Cc[:, :, None] * dyh).sum(-1)
    dcum = rowt - dtc * colv - d * ured + inter
    dcum[..., -1] += (d * ured).sum(-1) + torch.exp(cumc[..., -1]) \
        * (gc * hc).sum((-2, -1))
    ddt = colv + dec * ured
    # Per group of G heads: the running sums over its heads, then the
    # summed dW∘E∘dt's products.
    grp = (Bsz, nc, H // G, G)
    dcbt = (dwt * ex * dt_j).reshape(*grp, chunk, chunk).sum(3)  # [.,g,j,i]
    db = (d[..., None] * gx).reshape(*grp, chunk, N).sum(3) \
        + tf32_mm(dcbt, Cc[:, :, None], NATURAL, terms)
    dc = (ecum[..., None] * dyh).reshape(*grp, chunk, N).sum(3) \
        + tf32_mm(dcbt.transpose(-1, -2), Bc[:, :, None], NATURAL, terms)

    def rows(t):                  # [b,c,h,Q] -> [B,L,H]
        return t.permute(0, 1, 3, 2).reshape(Bsz, L, H)

    def parts(t):                 # [b,c,g,Q,N] -> [groups,B,L,N]
        return t.permute(2, 0, 1, 3, 4).reshape(-1, Bsz, L, N)
    return (dx.permute(0, 1, 3, 2, 4).reshape(Bsz, L, H, P), rows(dcum),
            rows(ddt), parts(db), parts(dc))


def emulate_tf32_chunk_bwd_tiled(x, dt, cum, Bm, Cm, dy, g, h_prev, chunk,
                                 heads_per_group, terms=3, rows=64):
    """``ssd_chunk_bwd_tf32_tiled``'s arithmetic over tiles of ``rows``
    rows, as ``ssd_chunk_bwd_ref``'s outputs: each product's operands and
    slots as :func:`emulate_tf32_chunk_bwd`'s; per row block K, dx_K's
    intra term on the diagonal continuing the state term d_j (B·g)_j's sum,
    each column tile (I, K), I > K, summed from zero and added in order;
    the group's summed dW∘E∘dt split once per tile: on the diagonal
    against C_K (into dB_K) and B_K (into dC_K), on each column tile
    against C_I (into dB_K), on each row tile (K, J), J < K, against B_J
    (into dC_K), each product summed from zero and added in order."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    nc, G, nb = L // chunk, heads_per_group, chunk // rows
    f32 = torch.float32

    def heads(t, width):          # [B,L,H,w] -> [b,c,h,Q,w]
        return t.to(f32).reshape(Bsz, nc, chunk, H, width).permute(
            0, 1, 3, 2, 4)
    xc, dyc = heads(x, P), heads(dy, P)
    dtc = dt.to(f32).reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)
    cumc = cum.to(f32).reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)
    Bc = Bm.to(f32).reshape(Bsz, nc, chunk, N)
    Cc = Cm.to(f32).reshape(Bsz, nc, chunk, N)
    gc, hc = g.to(f32), h_prev.to(f32)                      # [b,c,h,n,p]
    cbt = tf32_mm(Bc, Cc.transpose(-1, -2), PERMUTED, terms)  # [b,c,j,i]
    iota = torch.arange(chunk)
    causal_ji = iota[None, :] >= iota[:, None]               # i >= j
    seg = cumc[..., None, :] - cumc[..., :, None]            # [b,c,h,j,i]
    ex = torch.where(causal_ji, torch.exp(torch.where(causal_ji, seg, 0.0)),
                     0.0)
    dt_j = dtc[..., :, None]
    kv = cbt[:, :, None] * ex                                # Kᵀ [j, i]
    dwt = tf32_mm(xc, dyc.transpose(-1, -2), NATURAL, terms)  # dWᵀ [j, i]
    dec = torch.exp(cumc[..., -1:] - cumc)
    d = dec * dtc                                            # [b,c,h,j]
    bg = tf32_mm(Bc[:, :, None], gc, PERMUTED, terms)        # [b,c,h,j,p]
    ured = (xc * bg).sum(-1)
    v = dwt * kv
    colv = v.sum(-1)                                         # Σ_i V_ij
    rowt = (v * dt_j).sum(-2)                                # Σ_j T_ij
    gx = tf32_mm(xc, gc.transpose(-1, -2), NATURAL, terms)   # [b,c,h,j,n]
    dyh = tf32_mm(dyc, hc.transpose(-1, -2), NATURAL, terms)  # [b,c,h,i,n]
    ecum = torch.exp(cumc)
    inter = ecum * (Cc[:, :, None] * dyh).sum(-1)
    dcum = rowt - dtc * colv - d * ured + inter
    dcum[..., -1] += (d * ured).sum(-1) + torch.exp(cumc[..., -1]) \
        * (gc * hc).sum((-2, -1))
    ddt = colv + dec * ured
    grp = (Bsz, nc, H // G, G)
    dcbt = (dwt * ex * dt_j).reshape(*grp, chunk, chunk).sum(3)  # [.,g,j,i]
    db = (d[..., None] * gx).reshape(*grp, chunk, N).sum(3)
    dc = (ecum[..., None] * dyh).reshape(*grp, chunk, N).sum(3)
    blocks = [slice(k * rows, (k + 1) * rows) for k in range(nb)]
    Cg, Bg = Cc[:, :, None], Bc[:, :, None]
    dx = torch.empty_like(xc)
    for K, k in enumerate(blocks):
        acc = tf32_mm((kv * dt_j)[..., k, k], dyc[..., k, :], PERMUTED,
                      terms, init=(d[..., None] * bg)[..., k, :])
        db[..., k, :] += tf32_mm(dcbt[..., k, k], Cg[..., k, :], NATURAL,
                                 terms)
        dc[..., k, :] += tf32_mm(dcbt[..., k, k].transpose(-1, -2),
                                 Bg[..., k, :], NATURAL, terms)
        for i in blocks[K + 1:]:
            acc = acc + tf32_mm((kv * dt_j)[..., k, i], dyc[..., i, :],
                                PERMUTED, terms)
            db[..., k, :] += tf32_mm(dcbt[..., k, i], Cg[..., i, :],
                                     NATURAL, terms)
        for j in blocks[:K]:
            dc[..., k, :] += tf32_mm(dcbt[..., j, k].transpose(-1, -2),
                                     Bg[..., j, :], NATURAL, terms)
        dx[..., k, :] = acc

    def rows_(t):                 # [b,c,h,Q] -> [B,L,H]
        return t.permute(0, 1, 3, 2).reshape(Bsz, L, H)

    def parts(t):                 # [b,c,g,Q,N] -> [groups,B,L,N]
        return t.permute(2, 0, 1, 3, 4).reshape(-1, Bsz, L, N)
    return (dx.permute(0, 1, 3, 2, 4).reshape(Bsz, L, H, P), rows_(dcum),
            rows_(ddt), parts(db), parts(dc))


def emulate_tf32_carry(y_intra, states, cum, Cm, chunk, init_state=None,
                       out_dtype=torch.float32, terms=3):
    """``ssd_carry_tf32``'s arithmetic: the chain h = exp(cum_last)·h + S_c
    in fp32; each chunk's C·h_prev with C split as read and h_prev in the
    two TF32 planes the chain warps publish (permuted slots over n: the
    k slots c, c + 4 hold columns 2c, 2c + 1 of C, one 8-byte read); y =
    y_intra + exp(cum)·acc, cast to ``out_dtype``.  Returns (y [B,L,H,P],
    final state [B,H,N,P]) as ``ssd_carry_ref``."""
    Bsz, nc, H, N, P = states.shape
    L = nc * chunk
    f32 = torch.float32
    cumc = cum.to(f32).reshape(Bsz, nc, chunk, H)
    decay = torch.exp(cumc[:, :, -1, :])[..., None, None]   # [b,c,h,1,1]
    h = (torch.zeros((Bsz, H, N, P)) if init_state is None
         else init_state.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = decay[:, c] * h + states[:, c].to(f32)
    hp = torch.stack(h_prevs, 1)                            # [b,c,h,n,p]
    Cc = Cm.to(f32).reshape(Bsz, nc, 1, chunk, N)
    acc = tf32_mm(Cc, hp, PERMUTED, terms)                  # [b,c,h,i,p]
    y = y_intra.to(f32).reshape(Bsz, nc, chunk, H, P) \
        + torch.exp(cumc)[..., None] * acc.permute(0, 1, 3, 2, 4)
    return y.reshape(Bsz, L, H, P).to(out_dtype), h


def emulate_tf32_carry_bwd(states, cum, Cm, dy, chunk, init_state=None,
                           dfinal=None, terms=3):
    """``ssd_carry_bwd_tf32``'s arithmetic: the forward walk in fp32; the
    reverse walk's Σ_i exp(cum_i) C_i ⊗ dy_i per chunk as
    (exp(cum) ∘ C)ᵀ·dy, C scaled by exp(cum_i) in fp32 and then split, dy
    split as read (natural slots over i), the chunk's 64-row slabs in
    order into one running sum (one slab up to 64 rows), and g =
    exp(cum_last)·g + that product.
    Returns (h_prev, g, d init_state) as ``ssd_carry_bwd_ref``."""
    Bsz, nc, H, N, P = states.shape
    f32 = torch.float32
    cumc = cum.to(f32).reshape(Bsz, nc, chunk, H)
    decay = torch.exp(cumc[:, :, -1, :])[..., None, None]
    h = (torch.zeros((Bsz, H, N, P)) if init_state is None
         else init_state.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = decay[:, c] * h + states[:, c].to(f32)
    ec = Cm.to(f32).reshape(Bsz, nc, chunk, 1, N) \
        * torch.exp(cumc)[..., None]                        # [b,c,i,h,n]
    dyc = dy.to(f32).reshape(Bsz, nc, chunk, H, P).permute(0, 1, 3, 2, 4)
    ect = ec.permute(0, 1, 3, 4, 2)                         # [b,c,h,n,i]
    slab = min(chunk, 64)
    cdy = None
    for s in range(0, chunk, slab):
        cdy = tf32_mm(ect[..., s:s + slab], dyc[..., s:s + slab, :],
                      NATURAL, terms, init=cdy)
    g = torch.zeros((Bsz, H, N, P)) if dfinal is None else dfinal.to(f32)
    gs = [g] * nc
    for c in reversed(range(nc)):
        gs[c] = g
        g = decay[:, c] * g + cdy[:, c]
    return torch.stack(h_prevs, 1), torch.stack(gs, 1), g
