"""Device beam-search diplotype solver — the production phasing engine.

Accelerator-first redesign of the reference's A* search (ref: src/astar_phaser.rs):
instead of a pointer-chasing priority queue, phase blocks become dense
``[reads × variants]`` allele/qual matrices and the search runs as a
*lockstep beam* over variants. Key observation: the reference's A* heuristic
only mediates cross-depth priority; within one depth it is a constant and
cancels, so a fixed-width beam ranked by exact integer MEC cost explores the
same frontier with no heuristic sweep at all. The reference's queue-size
schedule (``min_queue_size + queue_increment·progress``) is itself an
adaptive beam width, so width ≥ that schedule preserves the argmin.

Tie-breaking replicates the reference: (min cost, max num_hets, insertion
order), with expansion order 0|1, 1|0, 0/0, 1/1 and the 1|0 twin suppressed
while a node's haplotypes are identical (symmetry breaking,
ref: astar_phaser.rs:535-560).

The device program is **variant-tiled**: one jitted ``beam_tile_packed``
advances the beam over a fixed-size window of variant columns and returns
the backtrace slices for those columns to the host. The beam state (per-slot
running costs, totals, flags) is carried across tile calls, so a block of
ANY variant count runs through ONE compiled program shape — there is no
re-lowering per block size and no upper bound on block length (this replaces
both the per-bucket jit cache and the giant-block host fallback). The final
haplotype backtrace is a trivial host pass over the collected tile slices.

Optimality accounting (ref contract: pruned == 0 ⇒ provably optimal,
docs/user_guide.md:310): at each step the kernel also reports the number of
discarded candidates and the *minimum cost among them*. Since extension never
decreases cost, a candidate discarded at cost c can only finish at ≥ c;
after the solve, discards with c > final_cost provably couldn't have beaten
(or tied) the result, so ``pruned`` sums only the steps whose cheapest
discard was ≤ the final cost.

Everything is jittable with static shapes; blocks are padded to bucket sizes
and batched, then sharded data-parallel over a device mesh (see
`hiphase_jax.parallel`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# Invalid-candidate sentinel for ranking keys. Plain Python int (a jnp
# scalar here would live on the default device and every lowering would
# fetch it back to embed it as a constant). Must exceed any
# legitimate block cost: the slotted worst case is
# 1024 slots x 8192 variants x qual 160 ~= 1.34e9, so sit just under the
# int32 ceiling.
BIG = 2_147_000_000

# Secondary ranking key packs (max_hets − hets, insertion order) into one
# int32: hets in the high bits (inverted so fewer-hets ranks later), the
# candidate's flat index (slot·4 + choice) in the low bits. The bit split is
# derived from the beam width so any --phase-min-queue-size is safe: the
# order field must hold 4·W candidate indices, and the het counter gets the
# remaining bits (callers gate blocks with more hets to the host oracle).


def order_bits_for(width: int) -> int:
    """Low bits reserved for the flat candidate index (slot·4 + choice)."""
    return max(2, (4 * width - 1).bit_length())


def max_hets_for(width: int) -> int:
    """Largest per-block het count the packed sort key can carry."""
    return (1 << (31 - order_bits_for(width))) - 1


# Default-width ceiling (W ≤ 2048 → 262143 hets); kept as a module constant
# for callers that size host-side buffers before choosing a width.
MAX_HETS = max_hets_for(2048)

# Extension order: 0|1, 1|0, 0/0, 1/1 (ref: astar_phaser.rs:535-540).
# Encoded arithmetically so no constant tables are embedded in the program:
#   a1(c)  = c & 1                       -> [0, 1, 0, 1]
#   a2(c)  = 1 - ((c & 1) ^ (c >> 1))    -> [1, 0, 0, 1]
#   het(c) = 1 - (c >> 1)                -> [1, 1, 0, 0]
#   identical-preserving(c) = c >> 1     -> [0, 0, 1, 1]


def _choice_a1(c):
    return c & 1


def _choice_a2(c):
    return 1 - ((c & 1) ^ (c >> 1))


@dataclass
class BeamResult:
    h1: np.ndarray        # [B, V] uint8 alleles (0/1; 2 where skipped)
    h2: np.ndarray        # [B, V]
    cost: np.ndarray      # [B] int32 final MEC cost
    num_hets: np.ndarray  # [B] int32
    pruned: np.ndarray    # [B] int32 discards that could have ≤ final cost;
    #                       0 ⇒ provably optimal


def _step(state, inputs, beam_width: int):
    """One lockstep beam extension over a single variant column.

    Slot semantics: the R axis indexes read *slots*, not reads. A slot is
    reused by successive non-overlapping reads; ``reset_next`` marks slots
    whose read ends before the NEXT column — their contribution is folded
    into the candidate's scalar base cost at the end of this step
    (lookahead folding), so the per-slot state is written exactly once per
    column (the tensorized analog of the reference's frozen/fluid split,
    ref: astar_phaser.rs:89-108).

    Delta-cost formulation: instead of carrying both haplotype cost vectors
    (c1, c2) per slot, carry ONLY ``delta = c1 − c2`` per slot plus the
    scalar total ``cost``. Identities used:
      min(c1, c2)     = c2 + min(delta, 0)
      total cost      = fbase + Σ_r min(δ_r, 0),  fbase := frozen + Σ_r c2_r
      fold of slot r  : frozen += c2_r + min(δ_r,0); Σc2 −= c2_r
                        ⇒ fbase += min(δ_r, 0)   (the c2_r cancels!)
      extension (d1,d2): delta += d1 − d2; fbase += Σ d2
    and crucially the INVARIANT  cost = fbase + Σ min(δ, 0)  holds at every
    step boundary (a fold moves min(δ_r,0) from the sum into fbase, leaving
    the total unchanged), so fbase itself never needs to be stored: it is
    recovered as cost − m0. Likewise ``identical`` (symmetry-breaking
    flag) ⟺ hets == 0. The survivor permutation therefore gathers exactly
    ONE [B, W, R] array — delta — where the (c1, c2, frozen, ident)
    formulation paid for three additional gathers of the same index set
    (scripts/ablate_beam.py measures each part of the step).
    """
    delta, cost, hets, valid = state
    # a_j: [B, R] slot alleles at this variant; q_j: [B, R] int32 quals
    a_j, q_j, skip, reset_next = inputs  # skip: [B]; reset_next: [B, R]
    B, W, R = delta.shape

    # Parent-independent per-column quantities. ``qe`` gates skipped
    # columns to zero cost so all four children tie at the parent's total
    # (the reference extends ignored variants as Ambiguous/Ambiguous at
    # equal cost, ref: astar_phaser.rs:517-531).
    qe = jnp.where(skip[:, None], 0, q_j)                       # [B, R]
    q_if0 = jnp.where(a_j == 0, qe, 0)    # cost of hap-allele 1 at slot
    q_if1 = jnp.where(a_j == 1, qe, 0)    # cost of hap-allele 0 at slot
    e0 = q_if1 - q_if0                    # d1 − d2 for choice 0 (0|1)
    sum_q0 = jnp.sum(q_if0, axis=-1, dtype=jnp.int32)           # [B]
    sum_q1 = jnp.sum(q_if1, axis=-1, dtype=jnp.int32)
    # D2[c] = Σ_r d2_r(c); a2 per choice is [1, 0, 0, 1]
    D2 = jnp.stack([sum_q0, sum_q1, sum_q1, sum_q0], axis=-1)   # [B, 4]

    # one fused read pass over delta: the three min-sum reductions
    m0 = jnp.sum(jnp.minimum(delta, 0), axis=-1, dtype=jnp.int32)
    mp = jnp.sum(jnp.minimum(delta + e0[:, None, :], 0), axis=-1,
                 dtype=jnp.int32)
    mm = jnp.sum(jnp.minimum(delta - e0[:, None, :], 0), axis=-1,
                 dtype=jnp.int32)
    # cand_cost = fbase + D2[c] + m_c with fbase = cost − m0 (invariant).
    # Invalid slots carry cost = BIG, but |m_c − m0| ≤ Σ|e0| keeps the
    # masked-out expression comfortably inside int32.
    base = cost - m0
    cand_cost = jnp.stack([
        base + D2[:, 0:1] + mp,   # 0|1
        base + D2[:, 1:2] + mm,   # 1|0
        base + D2[:, 2:3] + m0,   # 0/0
        base + D2[:, 3:4] + m0,   # 1/1
    ], axis=-1)  # [B, W, 4]

    choice_ids = jax.lax.broadcasted_iota(jnp.int32, (B, W, 4), 2)
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (B, W, 4), 1)

    het_inc = jnp.where(skip[:, None, None], 0, 1 - (choice_ids >> 1))
    cand_hets = hets[:, :, None] + het_inc
    identical = hets == 0  # no het choice yet ⟺ haplotypes identical

    cand_valid = jnp.broadcast_to(valid[:, :, None], (B, W, 4))
    # symmetry breaking: no 1|0 while haplotypes identical
    cand_valid &= ~(identical[:, :, None] & (choice_ids == 1))
    # skipped/pad variants spawn exactly one child
    cand_valid &= (~skip[:, None, None]) | (choice_ids == 0)

    # rank by (cost, -hets, insertion order) via a two-key sort; the
    # secondary key packs hets and the flat candidate index so the survivors'
    # parent/choice/hets decode straight out of the sorted keys (one sort of
    # two int32 operands instead of a 7-operand sort)
    order_bits = order_bits_for(beam_width)
    hets_cap = max_hets_for(beam_width)
    order = slot_ids * 4 + choice_ids
    k_cost = jnp.where(cand_valid, cand_cost, BIG).reshape(B, W * 4)
    k_sec = ((hets_cap - cand_hets) << order_bits | order).reshape(B, W * 4)
    sorted_cost, sorted_sec = jax.lax.sort((k_cost, k_sec), num_keys=2)

    new_cost = sorted_cost[:, :beam_width]
    sec = sorted_sec[:, :beam_width]
    sel_flat = sec & ((1 << order_bits) - 1)         # slot·4 + choice
    sel_parent = sel_flat >> 2
    sel_choice = sel_flat & 3
    new_hets = hets_cap - (sec >> order_bits)
    new_valid = new_cost < BIG

    bidx = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
    n_valid = jnp.sum(cand_valid.reshape(B, W * 4), axis=-1, dtype=jnp.int32)
    pruned_now = jnp.maximum(n_valid - beam_width, 0)
    # cheapest discarded candidate (the first sorted-out entry); BIG when the
    # frontier fit in the beam — the host compares this against the final
    # cost to decide whether optimality is still provable
    discard_min = sorted_cost[:, beam_width] if W * 4 > beam_width \
        else jnp.full((B,), BIG, dtype=jnp.int32)

    # gather the survivors' per-slot deltas (the ONE gathered array in
    # this formulation) and roll the chosen
    # extension in; e(c) is +e0 for 0|1, −e0 for 1|0, 0 for homs/skips.
    # The lookahead fold is just zeroing finished slots: the carried cost
    # already equals fbase + Σ min(δ,0) whether or not the fold happened
    # (the fold moves a min(δ_r,0) term between the two summands).
    pdelta = delta[bidx, sel_parent]  # [B, W, R]
    sgn = jnp.where(sel_choice == 0, 1,
                    jnp.where(sel_choice == 1, -1, 0))      # [B, W]
    new_delta = pdelta + sgn[:, :, None] * e0[:, None, :]
    new_delta = jnp.where(reset_next[:, None, :], 0, new_delta)

    new_state = (new_delta, new_cost, new_hets, new_valid)
    return new_state, (sel_parent.astype(jnp.int16),
                       sel_choice.astype(jnp.int8),
                       pruned_now, discard_min)


def beam_init_state(batch: int, num_slots: int, beam_width: int):
    """Fresh beam state for a batch (numpy; transferred/sharded on first
    tile call). Layout: (delta [B,W,R], cost [B,W], hets [B,W],
    valid [B,W]) — see the delta-cost formulation in `_step`."""
    B, R, W = batch, num_slots, beam_width
    valid = np.zeros((B, W), dtype=bool)
    valid[:, 0] = True
    return (np.zeros((B, W, R), dtype=np.int32),
            np.zeros((B, W), dtype=np.int32),
            np.zeros((B, W), dtype=np.int32),
            valid)


_INIT_CACHE: dict = {}


def beam_init_device(batch: int, num_slots: int, beam_width: int,
                     sharding=None):
    """Fresh beam state created ON the device (optionally sharded) — the
    `4·B·W·R` bytes of zeros never cross the host↔device link. Jitted
    constructors are cached per (shape, sharding)."""
    key = (batch, num_slots, beam_width, sharding)
    fn = _INIT_CACHE.get(key)
    if fn is None:
        def make():
            c = jnp.zeros((batch, beam_width, num_slots), jnp.int32)
            z = jnp.zeros((batch, beam_width), jnp.int32)
            valid = jax.lax.broadcasted_iota(
                jnp.int32, (batch, beam_width), 1) == 0
            return (c, z, z, valid)
        out_sh = None if sharding is None else (sharding,) * 4
        fn = jax.jit(make, out_shardings=out_sh)
        _INIT_CACHE[key] = fn
    return fn()


# ---------------------------------------------------------------------------
# Packed single-transfer input path. Per-element bit layout of one int32:
#   bits 0-15  qual (flip cost; callers' quality ladder tops out at 160)
#   bits 16-17 allele (0/1 set, 2 ambiguous, 3 no-overlap)
#   bit  18    reset (slot handoff before this column)
# One [B, R, V] int32 array + one [B, V] skip array = TWO host->device
# transfers per batch, independent of how many tiles the batch spans; each
# transfer pays a fixed launch latency on top of its bytes.

QUAL_BITS = 16
QUAL_MASK = (1 << QUAL_BITS) - 1


def pack_inputs(alleles: np.ndarray, quals: np.ndarray,
                resets: np.ndarray) -> np.ndarray:
    """Pack (alleles, quals, resets) into one int32 array (see layout)."""
    quals = np.asarray(quals)
    assert quals.size == 0 or int(quals.max()) <= QUAL_MASK
    return (quals.astype(np.int32)
            | (np.asarray(alleles).astype(np.int32) << QUAL_BITS)
            | (np.asarray(resets).astype(np.int32) << (QUAL_BITS + 2)))


# packed value of a padding cell: allele 3 (no overlap), qual 0, no reset
PACK_PAD = 3 << QUAL_BITS


@functools.partial(jax.jit, static_argnames=("beam_width",))
def beam_tile_packed(state, packed, skip, beam_width: int):
    """Advance the beam over one tile of T variant columns.

    Args:
      state: carried beam state (`beam_init_state` / `beam_init_device` /
        a prior tile).
      packed: [B, R, T+1] int32 — see `pack_inputs`. Columns 0..T−1 are
        scored; column j+1's RESET bit folds at the end of step j
        (lookahead folding), which is why one extra column rides along.
      skip: [B, T] bool — ignored variants and padding columns.
      beam_width: static beam width.

    Returns (state, (parents [T,B,W] i16, choices [T,B,W] i8,
    pruned_cnt [T,B] i32, discard_min [T,B] i32)).
    """
    T = skip.shape[1]
    assert packed.shape[2] == T + 1, (packed.shape, T)
    cols = packed[:, :, :T]
    alleles = (cols >> QUAL_BITS) & 3
    quals = cols & QUAL_MASK
    reset_next = ((packed[:, :, 1:] >> (QUAL_BITS + 2)) & 1).astype(bool)
    xs = (jnp.moveaxis(alleles, 2, 0),
          jnp.moveaxis(quals, 2, 0),
          jnp.moveaxis(skip, 1, 0),
          jnp.moveaxis(reset_next, 2, 0))
    step = functools.partial(_step, beam_width=beam_width)
    return jax.lax.scan(step, state, xs)


def tiles_forward_packed(state, packed_d, skip_d, beam_width: int,
                         tile: int):
    """Forward tile chain over DEVICE-resident packed inputs. Tile slices
    are cut on the device (`lax.slice_in_dim` on committed arrays), so the
    chain costs zero additional host->device transfers; every tile is still
    the ONE compiled `beam_tile_packed` shape.

    ``packed_d`` must carry Vp+1 columns (a trailing PACK_PAD column), the
    +1 feeding each tile's lookahead reset plane."""
    Vp = skip_d.shape[1]
    assert packed_d.shape[2] == Vp + 1, (packed_d.shape, Vp)
    traces = []
    for t0 in range(0, Vp, tile):
        pk = jax.lax.slice_in_dim(packed_d, t0, t0 + tile + 1, axis=2)
        sk = jax.lax.slice_in_dim(skip_d, t0, t0 + tile, axis=1)
        state, ys = beam_tile_packed(state, pk, sk, beam_width=beam_width)
        traces.append(ys)
    return state, traces


def tiles_backtrace_device(traces, skip_d, tile: int
                           ) -> tuple[np.ndarray, np.ndarray]:
    """`tiles_backtrace` over a DEVICE-resident skip array; one device→host
    transfer for the packed haplotypes."""
    B = skip_d.shape[0]
    slot = jnp.zeros(B, dtype=jnp.int32)
    h1_parts = []
    h2_parts = []
    for i in range(len(traces) - 1, -1, -1):
        parents, choices = traces[i][0], traces[i][1]
        sk = jax.lax.slice_in_dim(skip_d, i * tile, (i + 1) * tile, axis=1)
        slot, h1t, h2t = backtrace_tile(slot, parents, choices, sk)
        h1_parts.append(h1t)
        h2_parts.append(h2t)
    h1_parts.reverse()
    h2_parts.reverse()
    packed = np.asarray(jnp.concatenate(h1_parts + h2_parts, axis=0))
    Vp = packed.shape[0] // 2
    return packed[:Vp].T, packed[Vp:].T


@jax.jit
def backtrace_tile(slot, parents, choices, skip):
    """Device backtrace over one tile, newest-to-oldest.

    The forward trace arrays ([T, B, W] per tile) stay in device memory —
    only the [T, B] haplotype slices and the [B] carried slot go back to
    the host.

    Args: slot [B] i32 (carried; zeros to start from the final argmin),
    parents [T,B,W] i16, choices [T,B,W] i8, skip [B,T] bool.
    Returns (slot, h1 [T,B] u8, h2 [T,B] u8).
    """
    def back(slot, inp):
        par_j, cho_j, skip_j = inp  # [B, W], [B, W], [B]
        bidx = jax.lax.broadcasted_iota(jnp.int32, (par_j.shape[0],), 0)
        ch = cho_j[bidx, slot].astype(jnp.int32)
        h1 = jnp.where(skip_j, 2, ch & 1).astype(jnp.uint8)
        h2 = jnp.where(skip_j, 2, 1 - ((ch & 1) ^ (ch >> 1))).astype(jnp.uint8)
        return par_j[bidx, slot].astype(jnp.int32), (h1, h2)

    slot, (h1, h2) = jax.lax.scan(
        back, slot, (parents, choices, jnp.moveaxis(skip, 1, 0)),
        reverse=True)
    return slot, h1, h2


def pack_job_stats(state, traces):
    """Device-side packing of (cost, hets, pruned_cnt, discard_min) into one
    int32 array [2 + 2·Vp, B] so materialization is a single transfer."""
    cost = state[1][:, 0].astype(jnp.int32)
    hets = state[2][:, 0].astype(jnp.int32)
    cnt = [t[2] for t in traces]
    dmin = [t[3] for t in traces]
    return jnp.concatenate([cost[None], hets[None]] + cnt + dmin, axis=0)


def unpack_job_stats(packed: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host side of `pack_job_stats`: returns (cost, hets, pruned).

    Pruned accounting: a discard at cost > the final cost can never have
    beaten or tied the result, so it doesn't spoil provable optimality."""
    cost = packed[0]
    hets = packed[1]
    Vp = (packed.shape[0] - 2) // 2
    cnt = packed[2:2 + Vp]
    dmin = packed[2 + Vp:]
    pruned = np.sum(cnt * (dmin <= cost[None, :]), axis=0).astype(np.int32)
    return cost, hets, pruned


def beam_solve_batch(alleles, quals, skip, beam_width: int = 256,
                     resets=None, tile: int | None = None):
    """Solve a padded batch of phase blocks via the tiled device kernel.

    Args:
      alleles: [B, R, V] uint8 — 0/1 set, 2 ambiguous, 3 no-overlap. The R
        axis is read *slots*: non-overlapping reads may share a slot when
        ``resets`` marks the handoff (see tensorize_block).
      quals:   [B, R, V] int32 — flip costs; 0 wherever allele unset.
      skip:    [B, V] bool — true for ignored variants AND padding columns
        (j >= num_variants of the block).
      beam_width: beam width (the effective queue size;
        ref: astar_phaser.rs:451-502).
      resets:  [B, R, V] bool — slot s finishes its previous read before
        column v (fold min cost into frozen, restart slot). None → no reuse.
      tile: variant-tile size; columns are processed in ceil(V/tile) calls
        of one compiled shape. None → a single tile of exactly V columns.

    Returns (h1, h2, cost, num_hets, pruned) — see BeamResult.
    """
    alleles = np.asarray(alleles)
    quals = np.asarray(quals)
    skip = np.asarray(skip)
    B, R, V = alleles.shape
    if resets is None:
        resets = np.zeros((B, R, V), dtype=bool)
    else:
        resets = np.asarray(resets)

    T = V if tile is None else int(tile)
    Vp = ((V + T - 1) // T) * T if T > 0 else V
    if Vp > V:
        pad = ((0, 0), (0, 0), (0, Vp - V))
        alleles = np.pad(alleles, pad, constant_values=3)
        quals = np.pad(quals, pad)
        resets = np.pad(resets, pad)
        skip = np.pad(skip, ((0, 0), (0, Vp - V)), constant_values=True)

    state = beam_init_device(B, R, beam_width)
    packed = np.pad(pack_inputs(alleles, quals, resets),
                    ((0, 0), (0, 0), (0, 1)), constant_values=PACK_PAD)
    packed_d = jax.device_put(packed)
    skip_d = jax.device_put(skip)
    state, traces = tiles_forward_packed(state, packed_d, skip_d,
                                         beam_width, T)
    cost, hets, pruned = unpack_job_stats(
        np.asarray(pack_job_stats(state, traces)))
    h1, h2 = tiles_backtrace_device(traces, skip_d, T)
    return h1[:, :V], h2[:, :V], cost, hets, pruned


def solve_blocks(alleles: np.ndarray, quals: np.ndarray, skip: np.ndarray,
                 beam_width: int = 256,
                 resets: np.ndarray | None = None,
                 tile: int | None = None) -> BeamResult:
    """Host wrapper: run the tiled batch solver and materialize results."""
    h1, h2, cost, hets, pruned = beam_solve_batch(
        alleles, quals, skip, beam_width=beam_width, resets=resets, tile=tile)
    return BeamResult(h1, h2, cost, hets, pruned)


def assign_slots(read_segments) -> tuple[list[int], int]:
    """Interval-allocate reads to reusable slots. Returns (slot per read,
    slot count). Reads ordered by start reuse the slot whose previous
    occupant ended earliest (long phase blocks have reads spanning only a
    small variant window, so slots ≪ reads)."""
    import heapq
    order = sorted(range(len(read_segments)),
                   key=lambda i: (read_segments[i].start, read_segments[i].end))
    slots = [0] * len(read_segments)
    free: list[tuple[int, int]] = []  # (end, slot)
    next_slot = 0
    for i in order:
        rs = read_segments[i]
        if free and free[0][0] <= rs.start:
            _, s = heapq.heappop(free)
        else:
            s = next_slot
            next_slot += 1
        slots[i] = s
        heapq.heappush(free, (rs.end, s))
    return slots, max(next_slot, 1)


def tensorize_block(read_segments, variants, num_reads_pad: int,
                    num_variants_pad: int, slotted: bool = False):
    """Pack one block's ReadSegments + Variants into padded arrays for
    `beam_solve_batch`.

    Dense mode (default): one row per read; returns (alleles [R,V] u8,
    quals [R,V] i32, skip [V] bool).

    Slotted mode: rows are reusable slots (``num_reads_pad`` must be ≥ the
    max concurrent reads); additionally returns resets [R,V] bool. This is
    what makes long blocks linear instead of quadratic on device.
    """
    R, V = num_reads_pad, num_variants_pad
    nv = len(variants)
    assert nv <= V
    alleles = np.full((R, V), 3, dtype=np.uint8)
    quals = np.zeros((R, V), dtype=np.int32)
    resets = np.zeros((R, V), dtype=bool)
    if slotted:
        slots, n_slots = assign_slots(read_segments)
        assert n_slots <= R, (n_slots, R)
        last_end = {}
        # iterate in slot-allocation order (by start) so the reset marks the
        # handoff between the slot's consecutive occupants
        order = sorted(range(len(read_segments)),
                       key=lambda i: (read_segments[i].start,
                                      read_segments[i].end))
        for i in order:
            rs = read_segments[i]
            s = slots[i]
            span = slice(rs.start, rs.end)
            alleles[s, span] = rs.alleles
            quals[s, span] = rs.quals
            prev = last_end.get(s)
            if prev is not None:
                assert prev <= rs.start
                resets[s, rs.start] = True  # fold before the new read enters
            last_end[s] = rs.end
    else:
        assert len(read_segments) <= R
        for i, rs in enumerate(read_segments):
            a, q = rs.to_padded(nv)
            alleles[i, :nv] = a
            quals[i, :nv] = q
    skip = np.ones(V, dtype=bool)
    for j, v in enumerate(variants):
        skip[j] = v.is_ignored
    # unset alleles must carry zero qual so they never contribute cost
    quals[(alleles >= 2)] = 0
    return (alleles, quals, skip, resets) if slotted else (alleles, quals, skip)
