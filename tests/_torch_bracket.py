"""A plain PyTorch emulation of the tall kernel K2's Cauchy bisection
(``optimization_solvers_tpu_torch/ops/csrc/lbfgsb_tall.cu``), in which a
probe reads only the coordinates whose breakpoints lie in the bracket.

The plain version (``fused_lbfgsb_tall._cauchy_bisection``) evaluates every
probe by a full pass over the coordinates.  The kernel splits each probe's
sums at the probe point t: over moving coordinates (breakpoint tb > 0),

    W^T d = -sum_{tb > t} g w,   W^T u = sum_{tb <= t} z w - t sum_{tb > t} g w,
    G2F   =  sum_{tb > t} g^2,

and carries the coordinates below the list's window ``[Lb, Hb]`` (sums of
z w, and ``Lmax``, their largest breakpoint) and above it (sums of g w and
g^2, and ``Hmin``, their smallest) as partial sums.  Each probe reads only
the listed coordinates and compacts the list to the window; a probe point
outside ``[Lmax, Hmin)`` makes the list every moving coordinate again.
This module runs that bookkeeping instance by instance with index lists,
so the tests can hold it against the full-pass probes.
"""

import math

import torch


def _seg_min(f1, f2, eps):
    if f2 > eps:
        return -f1 / f2
    return math.inf if f1 < 0.0 else 0.0


def bracket_bisection(tb, g, z, Y, S, th, M, *, eps, bisect_iters,
                      gcp_guard_maxseg):
    """The kernel's bisection for one instance: ``tb``, ``g``, ``z`` (n,),
    ``Y``, ``S`` (m, n) chronological, ``th`` a float, ``M`` (2m, 2m).

    Returns ``(probes, t_lo_fin, dtm, multimodal, reads)``: ``probes`` lists
    ``(t_lo, t_hi, f1, f2)`` of each bisection probe, ``reads`` the number
    of coordinates each probe's sums read."""
    m = Y.shape[0]
    W = torch.cat([Y, S], 0)                          # (2m, n)
    moving = tb > 0.0
    fin = torch.isfinite(tb)

    def sums(idx, coef):
        return W[:, idx] @ coef[idx]

    def finish(PZ, PA, t, g2f):
        P2 = torch.cat([-PA[:m], th * -PA[m:]])
        C2 = torch.cat([PZ[:m] - t * PA[:m], th * (PZ[m:] - t * PA[m:])])
        pc = float(P2 @ (M @ C2))
        pp = float(P2 @ (M @ P2))
        return (th * t - 1.0) * g2f - pc, th * g2f - pp

    K = torch.nonzero(moving & fin).flatten()
    H = torch.nonzero(moving & ~fin).flatten()
    t_min = float(tb[moving].min()) if bool(moving.any()) else math.inf
    hi0 = float(tb[moving & fin].max()) if bool((moving & fin).any()) \
        else -math.inf
    AK, AH, ZK = sums(K, g), sums(H, g), sums(K, z)
    G2K, G2H = float((g[K] ** 2).sum()), float((g[H] ** 2).sum())
    has_fin = hi0 > 0.0
    zeros = torch.zeros_like(AK)
    f1, f2 = finish(zeros, AK + AH, 0.0, G2K + G2H)
    dt0 = _seg_min(f1, f2, eps)
    doneA = f1 >= 0.0
    doneB = not doneA and dt0 <= t_min
    doneC, dtL = False, 0.0
    if not doneA and not doneB:
        f1, f2 = finish(ZK, AH, hi0 if has_fin else 0.0, G2H)
        dtL = _seg_min(f1, f2, eps)
        doneC = has_fin and f1 < 0.0
    done = doneA or doneB or doneC
    t_fin = hi0 if doneC else 0.0
    dtm = 0.0 if doneA else (dt0 if doneB else dtL)
    b_lo, b_hi = t_min, hi0

    st = dict(lst=K, Lb=t_min, Hb=hi0, Lmax=0.0, Hmin=math.inf, ZL=zeros,
              AH=AH, G2H=G2H, whole=False)
    probes, reads = [], []

    def probe(t_at):
        if not st["whole"] and not (st["Lmax"] <= t_at < st["Hmin"]):
            st.update(lst=torch.nonzero(moving).flatten(), ZL=zeros,
                      AH=zeros, G2H=0.0, Lmax=0.0, Hmin=math.inf, Lb=0.0,
                      Hb=math.inf, whole=True)
        lst = st["lst"]
        t = tb[lst]
        keep = (st["Lb"] <= t) & (t <= st["Hb"])
        lst, t = lst[keep], t[keep]
        st["lst"] = lst
        lo_side, hi_side = t[t <= t_at], t[t > t_at]
        below = max(float(lo_side.max()) if len(lo_side) else 0.0,
                    st["Lmax"])
        above = min(float(hi_side.min()) if len(hi_side) else math.inf,
                    st["Hmin"])
        cnt = int(((t > b_lo) & (t <= b_hi)).sum())
        t_lo = below
        t_hi = above if below > 0.0 else t_min
        le = t <= t_lo
        ZK_le = sums(lst[le], z)
        AK_gt = sums(lst[~le], g)
        sK = float((g[lst[~le]] ** 2).sum())
        reads.append(len(lst))
        PZ, PA = st["ZL"] + ZK_le, st["AH"] + AK_gt
        f1, f2 = finish(PZ, PA, t_lo, st["G2H"] + sK)
        return t_lo, t_hi, f1, f2, PZ, PA, sK, below, above, cnt

    for _ in range(bisect_iters):
        if done:
            break
        t_lo, t_hi, f1, f2, PZ, PA, sK, below, above, _ = probe(
            math.sqrt(b_lo) * math.sqrt(b_hi))
        probes.append((t_lo, t_hi, f1, f2))
        dt = _seg_min(f1, f2, eps)
        if (f1 >= 0.0 and t_lo <= b_lo) or (f1 < 0.0 and t_lo + dt <= t_hi):
            done, t_fin, dtm = True, t_lo, dt
        elif f1 >= 0.0:
            b_hi = t_lo
            st.update(AH=PA, G2H=st["G2H"] + sK, Hmin=above, Hb=t_lo,
                      whole=False)
        elif f1 < 0.0:
            b_lo = t_hi
            st.update(ZL=PZ, Lmax=below, Lb=t_hi, whole=False)
    t_lo_fin, multimodal = t_fin, False
    if not done:
        t_lo, t_hi, f1, f2, _, _, _, _, _, cnt = probe(b_lo)
        t_lo_fin = t_lo
        dtm = min(max(_seg_min(f1, f2, eps), 0.0), t_hi - t_lo)
        multimodal = gcp_guard_maxseg > 0 and cnt <= gcp_guard_maxseg
    return probes, t_lo_fin, max(dtm, 0.0), multimodal, reads
