"""Device graph-WFA: banded edit-distance DP over the linearized variant DAG.

Accelerator-first redesign of the reference's wavefront aligner (SURVEY §7 K2,
ref: src/wfa_graph.rs:350-650). The host implementations (Python spec +
C++ production) propagate sparse per-(node, diagonal) wavefronts with
greedy match extension — data-dependent control flow that maps poorly to
XLA. This kernel instead runs a **banded edit-distance DP over the
topologically-linearized graph**:

  * every non-empty node contributes its characters to a position stream;
    empty (deletion-branch) nodes contribute one pass-through pseudo
    position;
  * the DP column for a position is a fixed band of read positions
    centered on the node's minimum root-path length (the expected read
    coordinate), so the whole alignment is ONE `lax.scan` over positions
    doing [B, band] vector work — no wavefront sets, no extension loops;
  * the in-column insertion recurrence D[k] = min(base[k], D[k−1] + 1) is
    closed in one shot with a cumulative min over (base[k] − k)
    (a min-plus prefix scan);
  * node joins read parents' end columns from a carried [B, N, band]
    buffer, rebased by each parent's path-length offset;
  * traversal/ambiguity sets are recovered by a backward pass that marks
    every cell on ANY optimal path (the union-of-optimal-paths semantics
    the reference's tie-set unions encode) — no interned bitsets.

Exactness: banded DP is exact when the optimal alignment stays inside the
band. Any alignment of score s through a graph whose root-path lengths
spread by at most ``spread`` stays within ``spread + s`` of the band
center, so a result is certified exact when ``score + spread <= H``;
otherwise the caller escalates the band (H ×4) and finally falls back to
the host aligner. Unlike the host engines this kernel does not emulate
``--global-pruning-distance`` (it computes the unpruned optimum); that
heuristic only changes results for reads lagging >500 columns behind
their own best alignment, which the host path almost always fails on
max-ED anyway.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

INF = 1 << 20


@dataclass
class GraphArrays:
    """Host-side linearization of a WFAGraph (see linearize_graph)."""

    n_nodes: int
    spread: int                 # max over nodes of (maxpath − minpath)
    total_pos: int
    pchar: np.ndarray           # [G] int32; −1 for eps pass-through
    pnode: np.ndarray           # [G] int32
    pstart: np.ndarray          # [G] bool: join before this position
    pend: np.ndarray            # [G] bool: write end column after
    c_out: np.ndarray           # [G] int32 band center AFTER the position
    par_idx: np.ndarray         # [G, P] int32 (−1 pad; only at starts)
    par_shift: np.ndarray       # [G, P] int32 endcol rebase per parent
    last_node: int
    c_end: int                  # band center at the final end column


def linearize_graph(graph) -> GraphArrays:
    """Flatten a WFAGraph into the position stream the kernel scans."""
    n = graph.num_nodes
    minpath = [0] * n
    maxpath = [0] * n
    nchars = [len(s) for s in graph.sequences]
    for i in range(1, n):
        ps = graph.parents[i]
        minpath[i] = min(minpath[p] + nchars[p] for p in ps)
        maxpath[i] = max(maxpath[p] + nchars[p] for p in ps)
    spread = max(maxpath[i] - minpath[i] for i in range(n))

    P = max(1, max((len(p) for p in graph.parents), default=1))
    pchar, pnode, pstart, pend, c_out = [], [], [], [], []
    par_idx, par_shift = [], []
    for i in range(n):
        seq = graph.sequences[i]
        npos = max(len(seq), 1)  # eps nodes get one pass-through position
        for j in range(npos):
            pchar.append(seq[j] if j < len(seq) else -1)
            pnode.append(i)
            pstart.append(j == 0 and i != 0)
            pend.append(j == npos - 1)
            c_out.append(minpath[i] + min(j + 1, len(seq)))
            if j == 0 and i != 0:
                row = [(p, minpath[p] + nchars[p] - minpath[i])
                       for p in graph.parents[i]]
                par_idx.append([p for p, _ in row] + [-1] * (P - len(row)))
                par_shift.append([s for _, s in row] + [0] * (P - len(row)))
            else:
                par_idx.append([-1] * P)
                par_shift.append([0] * P)
    return GraphArrays(
        n_nodes=n, spread=spread, total_pos=len(pchar),
        pchar=np.asarray(pchar, np.int32), pnode=np.asarray(pnode, np.int32),
        pstart=np.asarray(pstart, bool), pend=np.asarray(pend, bool),
        c_out=np.asarray(c_out, np.int32),
        par_idx=np.asarray(par_idx, np.int32),
        par_shift=np.asarray(par_shift, np.int32),
        last_node=n - 1, c_end=minpath[n - 1] + nchars[n - 1])


@functools.partial(
    __import__("jax").jit,
    static_argnames=("H", "n_nodes"))
def wfa_forward_backward(pchar, pnode, pstart, pend, c_out, par_idx,
                         par_shift, reads, read_len, H: int, n_nodes: int,
                         last_node, c_end):
    """Banded forward DP + backward optimal-path marking.

    Args: graph position arrays (see GraphArrays), reads [B, Lr] int32
    (padded), read_len [B] int32; H = band half-width (static).

    Returns (score [B] int32, traversed [B, N] bool, in_band [B] bool).
    A score of >= INF means no in-band alignment (caller escalates).
    """
    import jax
    import jax.numpy as jnp

    B, Lr = reads.shape
    Wb = 2 * H + 1
    karr = jnp.arange(Wb, dtype=jnp.int32)
    brow = jnp.arange(B, dtype=jnp.int32)[:, None]

    def closure(base):
        t = jax.lax.cummin(base - karr[None, :], axis=1)
        return jnp.minimum(t + karr[None, :], INF)

    def join_col(endcols, pidx, pshift):
        # [B, P, Wb] gather of parents' end columns, rebased by shift:
        # the same read position j sits at k_parent = k_child − dshift
        # (dshift = parent end center − child start center ≥ 0)
        pe = endcols[:, jnp.maximum(pidx, 0), :]          # [B, P, Wb]
        idx = karr[None, :] - pshift[:, None]             # [P, Wb]
        ok = (idx >= 0) & (pidx >= 0)[:, None]
        take = jnp.take_along_axis(
            pe, jnp.broadcast_to(jnp.maximum(idx, 0)[None], pe.shape),
            axis=-1)
        take = jnp.where(ok[None], take, INF)
        return jnp.min(take, axis=1)                      # [B, Wb]

    def transition(col, ch, c, is_eps):
        """col (post-join/closure input column) → (base, out)."""
        j = c + karr[None, :] - H                         # out-column j
        rchar = reads[brow, jnp.clip(j - 1, 0, Lr - 1)]
        sub = jnp.where(rchar == ch, 0, 1)
        diag = jnp.where(j >= 1, col + sub, INF)
        dele = jnp.concatenate(
            [col[:, 1:], jnp.full((B, 1), INF, jnp.int32)], axis=1) + 1
        base = jnp.where(is_eps, col, jnp.minimum(diag, dele))
        base = jnp.minimum(base, INF)
        out = closure(base)
        jv = (j >= 0) & (j <= read_len[:, None])
        out = jnp.where(jv, out, INF)
        return base, out

    # initial column at the root (center 0): D[j] = j
    init_col = jnp.where(karr[None, :] >= H, karr[None, :] - H, INF)
    init_col = jnp.where(karr[None, :] - H > read_len[:, None], INF,
                         init_col).astype(jnp.int32)
    init_col = jnp.broadcast_to(init_col, (B, Wb))
    endcols0 = jnp.full((B, n_nodes, Wb), INF, dtype=jnp.int32)

    def fwd_step(carry, xs):
        col, endcols = carry
        ch, node, start, end, c, pidx, pshift = xs
        col = jnp.where(start, closure(join_col(endcols, pidx, pshift)),
                        col)
        _base, out = transition(col, ch, c, ch < 0)
        upd = jax.lax.dynamic_update_slice(endcols, out[:, None, :],
                                           (0, node, 0))
        endcols = jnp.where(end, upd, endcols)
        return (out, endcols), (col, out)

    xs = (pchar, pnode, pstart, pend, c_out, par_idx, par_shift)
    (_fc, endcols), (cols_in, cols_out) = jax.lax.scan(
        fwd_step, (init_col, endcols0), xs)

    kstar = read_len - c_end + H
    in_band = (kstar >= 0) & (kstar < Wb)
    last = jax.lax.dynamic_slice(endcols, (0, last_node, 0),
                                 (B, 1, Wb))[:, 0, :]
    score = jnp.take_along_axis(
        last, jnp.clip(kstar, 0, Wb - 1)[:, None], axis=1)[:, 0]
    score = jnp.where(in_band, score, INF)

    # ---- backward: mark every cell on any optimal path ----
    def chain_left(mark, col):
        """Undo an insertion closure: solve the right-to-left recurrence
        P[k] = mark[k] | (link[k] & P[k+1]) with
        link[k] = (col[k+1] == col[k] + 1). Implemented as a FORWARD
        associative scan on flipped arrays whose combine applies the newer
        element outermost (associative_scan's own `reverse` flag composes
        the affine maps in the wrong order for this non-commutative op)."""
        link = jnp.concatenate(
            [col[:, 1:] == col[:, :-1] + 1, jnp.zeros((B, 1), bool)],
            axis=1)
        fm = jnp.flip(mark, axis=1)
        fl = jnp.flip(link, axis=1)

        def comb(acc, new):
            am, al = acc
            nm, nl = new
            return (nm | (nl & am), nl & al)

        pm, _ = jax.lax.associative_scan(comb, (fm, fl), axis=1)
        return jnp.flip(pm, axis=1)

    mark_final = (karr[None, :] == kstar[:, None]) & in_band[:, None] \
        & (score[:, None] < INF)
    mark_end0 = jnp.zeros((B, n_nodes, Wb), bool)
    mark_end0 = jax.lax.dynamic_update_slice(
        mark_end0, mark_final[:, None, :], (0, last_node, 0))
    trav0 = jnp.zeros((B, n_nodes), bool)

    def bwd_step(carry, xs):
        mark, mark_end, trav = carry
        ch, node, start, end, c, pidx, pshift, col_in, out = xs
        # marks routed from children arrive at this node's end column
        me = jax.lax.dynamic_slice(mark_end, (0, node, 0),
                                   (B, 1, Wb))[:, 0, :]
        mark = jnp.where(end, mark | me, mark)
        mark &= out < INF
        # this node is on an optimal path if any of its cells is marked
        trav = trav.at[:, node].max(jnp.any(mark, axis=1))
        # undo the out-closure, then the char transition back to col_in
        mark = chain_left(mark, out)
        is_eps = ch < 0
        j = c + karr[None, :] - H
        rchar = reads[brow, jnp.clip(j - 1, 0, Lr - 1)]
        sub = jnp.where(rchar == ch, 0, 1)
        base_diag = jnp.where(j >= 1, col_in + sub, INF)
        diag_ok = mark & (base_diag == out)
        dele_src = jnp.concatenate(
            [col_in[:, 1:], jnp.full((B, 1), INF, jnp.int32)], axis=1)
        # out[k] came from col_in[k+1] (deletion): the mark lands one cell
        # to the RIGHT in the input column
        dele_ok = mark & (dele_src + 1 == out)
        mark_in = jnp.where(
            is_eps, mark & (col_in == out),
            diag_ok | jnp.concatenate(
                [jnp.zeros((B, 1), bool), dele_ok[:, :-1]], axis=1))
        # at a node start, undo the join-closure and route to parents:
        # a marked joined cell equal to a parent's rebased end cell came
        # from that parent (ties mark several parents — the union
        # semantics)
        mark_in = jnp.where(start, chain_left(mark_in, col_in), mark_in)

        def route_one(p, mark_end):
            pid = pidx[p]
            shift = pshift[p]
            idx = karr - shift                  # parent cell for child k
            pe = jax.lax.dynamic_slice(
                endcols, (0, jnp.maximum(pid, 0), 0), (B, 1, Wb))[:, 0, :]
            pev = jnp.take_along_axis(
                pe, jnp.broadcast_to(jnp.maximum(idx, 0)[None],
                                     pe.shape), axis=-1)
            add = mark_in & (pev == col_in) & (idx >= 0)[None] \
                & (pid >= 0) & start
            # scatter back: mark_end[pid][k − shift] |= add[k]  — a
            # uniform shift, so it's a roll with an off-band mask
            shifted = jnp.roll(add, -shift, axis=1) \
                & (karr < Wb - shift)[None]
            cur = jax.lax.dynamic_slice(
                mark_end, (0, jnp.maximum(pid, 0), 0), (B, 1, Wb))[:, 0, :]
            return jax.lax.dynamic_update_slice(
                mark_end, (cur | shifted)[:, None, :],
                (0, jnp.maximum(pid, 0), 0))

        for p in range(pidx.shape[0]):
            mark_end = route_one(p, mark_end)

        # across a start boundary the previous position's column is NOT
        # the input column (the join replaced it) — marks flow via
        # mark_end only
        mark = jnp.where(start, jnp.zeros_like(mark_in), mark_in)
        return (mark, mark_end, trav), None

    xs_b = (pchar, pnode, pstart, pend, c_out, par_idx, par_shift,
            cols_in, cols_out)
    mark_init = jnp.zeros((B, Wb), bool)  # marks enter via mark_end
    (_m, _me, trav), _ = jax.lax.scan(
        bwd_step, (mark_init, mark_end0, trav0), xs_b, reverse=True)
    return score, trav, in_band


def _pad_up(n: int, mult: int) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def _padded_arrays(ga: GraphArrays):
    """Pad the position stream / parent table to bucketed shapes so the
    kernel compiles once per bucket, not once per graph. Pad positions are
    eps pass-throughs of the final column that never write end columns."""
    G = _pad_up(ga.total_pos, 64)
    P = _pad_up(ga.par_idx.shape[1], 2)
    N = _pad_up(ga.n_nodes, 16)
    pchar = np.full(G, -1, np.int32)
    pchar[:ga.total_pos] = ga.pchar
    pnode = np.full(G, ga.last_node, np.int32)
    pnode[:ga.total_pos] = ga.pnode
    pstart = np.zeros(G, bool)
    pstart[:ga.total_pos] = ga.pstart
    pend = np.zeros(G, bool)
    pend[:ga.total_pos] = ga.pend
    c_out = np.full(G, ga.c_end, np.int32)
    c_out[:ga.total_pos] = ga.c_out
    par_idx = np.full((G, P), -1, np.int32)
    par_idx[:ga.total_pos, :ga.par_idx.shape[1]] = ga.par_idx
    par_shift = np.zeros((G, P), np.int32)
    par_shift[:ga.total_pos, :ga.par_idx.shape[1]] = ga.par_shift
    return pchar, pnode, pstart, pend, c_out, par_idx, par_shift, N


H_LADDER = (32, 128, 512)


def align_reads_device(graph, reads: list[bytes], h_ladder=H_LADDER):
    """Align a batch of reads against ONE graph on the device backend.

    Returns a list parallel to ``reads``: (score, traversed_nodes) for
    reads whose banded result is certified exact (score + spread <= H), or
    None for reads the ladder could not certify — the caller falls back to
    the host aligner for those. Scores above graph.max_edit_distance are
    returned as-is; the caller applies the reference's max-ED failure
    semantics.
    """
    import jax

    ga = linearize_graph(graph)
    pchar, pnode, pstart, pend, c_out, par_idx, par_shift, N = \
        _padded_arrays(ga)
    results: list = [None] * len(reads)
    pending = list(range(len(reads)))
    for H in h_ladder:
        if not pending:
            break
        B = _pad_up(len(pending), 8)
        Lr = _pad_up(max((len(reads[i]) for i in pending), default=1), 256)
        arr = np.zeros((B, Lr), np.int32)
        rl = np.zeros(B, np.int32)
        for bi, ri in enumerate(pending):
            r = reads[ri]
            arr[bi, :len(r)] = np.frombuffer(bytes(r), np.uint8)
            rl[bi] = len(r)
        score, trav, _in_band = wfa_forward_backward(
            jax.device_put(pchar), jax.device_put(pnode),
            jax.device_put(pstart), jax.device_put(pend),
            jax.device_put(c_out), jax.device_put(par_idx),
            jax.device_put(par_shift), jax.device_put(arr),
            jax.device_put(rl), H=H, n_nodes=N,
            last_node=np.int32(ga.last_node), c_end=np.int32(ga.c_end))
        score = np.asarray(score)
        trav = np.asarray(trav)
        nxt = []
        for bi, ri in enumerate(pending):
            s = int(score[bi])
            if s < INF and s + ga.spread <= H:
                results[ri] = (s, [int(x)
                                   for x in np.flatnonzero(trav[bi])])
            else:
                nxt.append(ri)
        pending = nxt
    return results
