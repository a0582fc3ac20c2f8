"""Ablation microbench for the beam-step kernel: where does the time go?

Times one variant-tile advance (T columns) of a modified `_step` whose
selection / gather stages can be swapped or disabled, so the per-column cost
decomposes into (candidate scoring) + (selection) + (survivor gather).

Run one variant per process (selection strategy may need jax_enable_x64):

    python scripts/ablate_beam.py --variant sort2 --B 16
    python scripts/ablate_beam.py --variant topk64 --B 16   # enables x64

Prints one JSON line. Variants:
  sort2     current production: 2-key lax.sort over 4W candidates
  sort1_64  single-key int64 packed sort (needs x64)
  topk64    lax.top_k on negated int64 packed key (needs x64)
  topk_cost lax.top_k on negated int32 cost only (INEXACT tiebreak; speed
            bound for "what if selection were one int32 top_k")
  nosort    selection replaced by slice of the first W candidates (INEXACT;
            isolates scoring+gather without selection)
  nogather  sort kept, survivor state gather skipped (INEXACT; isolates
            scoring+selection without the [B,W,R] gathers)
  noscore   candidate costs replaced by iota (INEXACT; isolates
            selection+gather without the 4x [B,W,R] scoring reductions)
"""

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ap = argparse.ArgumentParser()
ap.add_argument("--variant", default="sort2")
ap.add_argument("--B", type=int, default=16)
ap.add_argument("--R", type=int, default=128)
ap.add_argument("--W", type=int, default=1024)
ap.add_argument("--T", type=int, default=128)
ap.add_argument("--reps", type=int, default=8)
ap.add_argument("--trials", type=int, default=3)
args = ap.parse_args()

if args.variant in ("sort1_64", "topk64"):
    import jax
    jax.config.update("jax_enable_x64", True)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from hiphase_jax.phasing.beam import (  # noqa: E402
    BIG, _choice_a1, _choice_a2, beam_init_state, max_hets_for,
    order_bits_for,
)


def _dstep(state, inputs, beam_width: int, variant: str):
    """Delta-form step variants (production is `beam._step`):
      dfull    replicate production (sanity baseline)
      dnored   min-sum reductions replaced by zeros (isolate reduction cost)
      dnogath  selection kept, delta gather skipped (isolate gather)
      dlook    reductions computed from new_delta at the END of the step
               (fused into the gather-update pass), carried to next step
    """
    if variant == "dlook":
        delta, fbase, cost, hets, identical, valid, m0, mp, mm = state
    else:
        delta, fbase, cost, hets, identical, valid = state
    a_j, q_j, skip, reset_next = inputs
    B, W, R = delta.shape

    qe = jnp.where(skip[:, None], 0, q_j)
    q_if0 = jnp.where(a_j == 0, qe, 0)
    q_if1 = jnp.where(a_j == 1, qe, 0)
    e0 = q_if1 - q_if0
    sum_q0 = jnp.sum(q_if0, axis=-1, dtype=jnp.int32)
    sum_q1 = jnp.sum(q_if1, axis=-1, dtype=jnp.int32)
    D2 = jnp.stack([sum_q0, sum_q1, sum_q1, sum_q0], axis=-1)

    if variant == "dnored":
        z = jnp.zeros((B, W), jnp.int32)
        m0, mp, mm = z, z, z
    elif variant != "dlook":
        m0 = jnp.sum(jnp.minimum(delta, 0), axis=-1, dtype=jnp.int32)
        mp = jnp.sum(jnp.minimum(delta + e0[:, None, :], 0), axis=-1,
                     dtype=jnp.int32)
        mm = jnp.sum(jnp.minimum(delta - e0[:, None, :], 0), axis=-1,
                     dtype=jnp.int32)

    cand_cost = jnp.stack([
        fbase + D2[:, 0:1] + mp,
        fbase + D2[:, 1:2] + mm,
        fbase + D2[:, 2:3] + m0,
        fbase + D2[:, 3:4] + m0,
    ], axis=-1)

    choice_ids = jax.lax.broadcasted_iota(jnp.int32, (B, W, 4), 2)
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (B, W, 4), 1)
    het_inc = jnp.where(skip[:, None, None], 0, 1 - (choice_ids >> 1))
    cand_hets = hets[:, :, None] + het_inc
    cand_ident = jnp.where(
        skip[:, None, None], identical[:, :, None],
        identical[:, :, None] & (choice_ids >> 1).astype(bool))
    cand_valid = jnp.broadcast_to(valid[:, :, None], (B, W, 4))
    cand_valid &= ~(identical[:, :, None] & (choice_ids == 1))
    cand_valid &= (~skip[:, None, None]) | (choice_ids == 0)

    order_bits = order_bits_for(beam_width)
    hets_cap = max_hets_for(beam_width)
    order = slot_ids * 4 + choice_ids
    k_cost = jnp.where(cand_valid, cand_cost, BIG).reshape(B, W * 4)
    k_sec = ((hets_cap - cand_hets) << order_bits | order).reshape(B, W * 4)
    sorted_cost, sorted_sec = jax.lax.sort((k_cost, k_sec), num_keys=2)
    new_cost = sorted_cost[:, :beam_width]
    sec = sorted_sec[:, :beam_width]
    sel_flat = sec & ((1 << order_bits) - 1)
    sel_parent = sel_flat >> 2
    sel_choice = sel_flat & 3
    new_hets = hets_cap - (sec >> order_bits)
    new_valid = new_cost < BIG
    bidx = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
    new_ident = cand_ident.reshape(B, W * 4)[bidx, sel_flat]

    if variant == "dnogath":
        new_delta, new_fbase = delta, fbase
    else:
        pdelta = delta[bidx, sel_parent]
        sgn = jnp.where(sel_choice == 0, 1,
                        jnp.where(sel_choice == 1, -1, 0))
        new_delta = pdelta + sgn[:, :, None] * e0[:, None, :]
        new_fbase = fbase[bidx, sel_parent] + D2[bidx, sel_choice]
        rn = reset_next[:, None, :]
        new_fbase = new_fbase + jnp.sum(
            jnp.where(rn, jnp.minimum(new_delta, 0), 0), axis=-1,
            dtype=jnp.int32)
        new_delta = jnp.where(rn, 0, new_delta)

    if variant == "dlook":
        # next column's reductions, fused with the update pass (uses this
        # column's e0 as a stand-in for the next column's — timing-
        # equivalent; production shifts the input planes by one)
        nm0 = jnp.sum(jnp.minimum(new_delta, 0), axis=-1, dtype=jnp.int32)
        nmp = jnp.sum(jnp.minimum(new_delta + e0[:, None, :], 0), axis=-1,
                      dtype=jnp.int32)
        nmm = jnp.sum(jnp.minimum(new_delta - e0[:, None, :], 0), axis=-1,
                      dtype=jnp.int32)
        new_state = (new_delta, new_fbase, new_cost, new_hets, new_ident,
                     new_valid, nm0, nmp, nmm)
    else:
        new_state = (new_delta, new_fbase, new_cost, new_hets, new_ident,
                     new_valid)
    return new_state, (sel_parent.astype(jnp.int16),
                       sel_choice.astype(jnp.int8))


SLIM_VARIANTS = ("snofull", "snosort", "snogath", "s16")


def _step_variant(state, inputs, beam_width: int, variant: str):
    if variant in SLIM_VARIANTS:
        return _sstep(state, inputs, beam_width, variant)
    if variant.startswith("d"):
        return _dstep(state, inputs, beam_width, variant)
    c1, c2, frozen, cost, hets, identical, valid = state
    a_j, q_j, skip, reset_j = inputs
    B, W, R = c1.shape

    if variant != "nofold":
        fold = jnp.where(reset_j[:, None, :], jnp.minimum(c1, c2), 0)
        frozen = frozen + jnp.sum(fold, axis=-1, dtype=jnp.int32)
        keep = ~reset_j[:, None, :]
        c1 = jnp.where(keep, c1, 0)
        c2 = jnp.where(keep, c2, 0)

    fluid = jnp.sum(jnp.minimum(c1, c2), axis=-1, dtype=jnp.int32)
    if variant == "noscore":
        cand_cost = jnp.broadcast_to(
            jax.lax.broadcasted_iota(jnp.int32, (1, W, 4), 1), (B, W, 4))
    else:
        cand_cost = []
        for c in range(4):
            d1 = jnp.where(a_j != _choice_a1(c), q_j, 0)
            d2 = jnp.where(a_j != _choice_a2(c), q_j, 0)
            total = frozen + jnp.sum(
                jnp.minimum(c1 + d1[:, None, :], c2 + d2[:, None, :]),
                axis=-1, dtype=jnp.int32)
            cand_cost.append(total)
        cand_cost = jnp.stack(cand_cost, axis=-1)
    skip_cost = frozen + fluid
    cand_cost = jnp.where(skip[:, None, None], skip_cost[:, :, None],
                          cand_cost)

    choice_ids = jax.lax.broadcasted_iota(jnp.int32, (B, W, 4), 2)
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (B, W, 4), 1)
    het_inc = jnp.where(skip[:, None, None], 0, 1 - (choice_ids >> 1))
    cand_hets = hets[:, :, None] + het_inc
    cand_ident = jnp.where(
        skip[:, None, None], identical[:, :, None],
        identical[:, :, None] & (choice_ids >> 1).astype(bool))
    cand_valid = jnp.broadcast_to(valid[:, :, None], (B, W, 4))
    cand_valid &= ~(identical[:, :, None] & (choice_ids == 1))
    cand_valid &= (~skip[:, None, None]) | (choice_ids == 0)

    order_bits = order_bits_for(beam_width)
    hets_cap = max_hets_for(beam_width)
    order = slot_ids * 4 + choice_ids
    k_cost = jnp.where(cand_valid, cand_cost, BIG).reshape(B, W * 4)
    k_sec = ((hets_cap - cand_hets) << order_bits | order).reshape(B, W * 4)

    if variant in ("sort2", "nogather", "noscore", "nofold"):
        sorted_cost, sorted_sec = jax.lax.sort((k_cost, k_sec), num_keys=2)
        new_cost = sorted_cost[:, :beam_width]
        sec = sorted_sec[:, :beam_width]
    elif variant == "sort1_64":
        packed = (k_cost.astype(jnp.int64) << 31) | k_sec.astype(jnp.int64)
        sp = jax.lax.sort(packed)
        new_cost = (sp[:, :beam_width] >> 31).astype(jnp.int32)
        sec = (sp[:, :beam_width] & ((1 << 31) - 1)).astype(jnp.int32)
    elif variant == "topk64":
        packed = (k_cost.astype(jnp.int64) << 31) | k_sec.astype(jnp.int64)
        negv, _idx = jax.lax.top_k(-packed, beam_width)
        new_cost = ((-negv) >> 31).astype(jnp.int32)
        sec = ((-negv) & ((1 << 31) - 1)).astype(jnp.int32)
    elif variant == "topk_cost":
        negv, idx = jax.lax.top_k(-k_cost, beam_width)
        new_cost = -negv
        bidx = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
        sec = k_sec[bidx, idx]
    elif variant == "nosort":
        new_cost = k_cost[:, :beam_width]
        sec = k_sec[:, :beam_width]
    else:
        raise SystemExit(f"unknown variant {args.variant}")

    sel_flat = sec & ((1 << order_bits) - 1)
    sel_parent = sel_flat >> 2
    sel_choice = sel_flat & 3
    new_hets = hets_cap - (sec >> order_bits)
    new_valid = new_cost < BIG

    bidx = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
    new_ident = cand_ident.reshape(B, W * 4)[bidx, sel_flat]

    if variant == "nogather":
        new_c1, new_c2, new_frozen = c1, c2, frozen
    else:
        pc1 = c1[bidx, sel_parent]
        pc2 = c2[bidx, sel_parent]
        new_frozen = frozen[bidx, sel_parent]
        sa1 = _choice_a1(sel_choice)
        sa2 = _choice_a2(sel_choice)
        d1 = jnp.where(a_j[:, None, :] != sa1[:, :, None], q_j[:, None, :], 0)
        d2 = jnp.where(a_j[:, None, :] != sa2[:, :, None], q_j[:, None, :], 0)
        nskip = ~skip[:, None, None]
        new_c1 = pc1 + jnp.where(nskip, d1, 0)
        new_c2 = pc2 + jnp.where(nskip, d2, 0)

    new_state = (new_c1, new_c2, new_frozen, new_cost, new_hets, new_ident,
                 new_valid)
    return new_state, (sel_parent.astype(jnp.int16),
                       sel_choice.astype(jnp.int8))


@functools.partial(jax.jit, static_argnames=("beam_width", "variant"))
def tile_variant(state, alleles, quals, skip, resets, beam_width, variant):
    xs = (jnp.moveaxis(alleles.astype(jnp.int32), 2, 0),
          jnp.moveaxis(quals.astype(jnp.int32), 2, 0),
          jnp.moveaxis(skip, 1, 0),
          jnp.moveaxis(resets, 2, 0))
    step = functools.partial(_step_variant, beam_width=beam_width,
                             variant=variant)
    return jax.lax.scan(step, state, xs)


def main():
    B, R, W, T = args.B, args.R, args.W, args.T
    rng = np.random.default_rng(0)
    alleles = rng.integers(0, 2, size=(B, R, T)).astype(np.uint8)
    quals = rng.integers(20, 80, size=(B, R, T)).astype(np.int32)
    skip = np.zeros((B, T), dtype=bool)
    resets = np.zeros((B, R, T), dtype=bool)
    dev_in = [jax.device_put(x) for x in (alleles, quals, skip, resets)]
    if args.variant in SLIM_VARIANTS:
        init = beam_init_state(B, R, W)  # production slim 4-tuple
        if args.variant == "s16":
            init = (init[0].astype(np.int16),) + init[1:]
        ci = 1
    elif args.variant.startswith("d"):
        init = beam_init_state(B, R, W)  # delta-form 6-tuple
        if args.variant == "dlook":
            z = np.zeros((B, W), dtype=np.int32)
            init = init + (z, z, z)
        ci = 2
    else:
        # legacy (c1, c2, frozen, ...) 7-tuple for the old-form variants
        valid = np.zeros((B, W), dtype=bool)
        valid[:, 0] = True
        init = (np.zeros((B, W, R), np.int32), np.zeros((B, W, R), np.int32),
                np.zeros((B, W), np.int32), np.zeros((B, W), np.int32),
                np.zeros((B, W), np.int32), np.ones((B, W), bool), valid)
        ci = 3
    state = tuple(jax.device_put(np.asarray(s)) for s in init)

    t0 = time.perf_counter()
    st, _ = tile_variant(state, *dev_in, beam_width=W, variant=args.variant)
    np.asarray(st[ci][:, 0])
    compile_s = time.perf_counter() - t0

    best = float("inf")
    for _ in range(args.trials):
        st = state
        t0 = time.perf_counter()
        for _ in range(args.reps):
            st, _ys = tile_variant(st, *dev_in, beam_width=W,
                                   variant=args.variant)
        np.asarray(st[ci][:, 0])
        best = min(best, (time.perf_counter() - t0) / args.reps)
    print(json.dumps({
        "variant": args.variant, "B": B, "R": R, "W": W, "T": T,
        "platform": jax.devices()[0].platform,
        "compile_s": round(compile_s, 2),
        "tile_ms": round(best * 1e3, 2),
        "col_us": round(best / T * 1e6, 1),
        "hets_per_sec": round(B * T / best, 1),
    }))
    return 0


# --- variants of the PRODUCTION slim step (delta, cost, hets, valid) ---
# snofull: replicate production; snosort: selection = first W; snogath:
# keep delta unpermuted; s16: delta carried as int16.
def _sstep(state, inputs, beam_width: int, variant: str):
    import jax
    import jax.numpy as jnp
    delta, cost, hets, valid = state
    a_j, q_j, skip, reset_next = inputs
    B, W, R = delta.shape
    qe = jnp.where(skip[:, None], 0, q_j)
    q_if0 = jnp.where(a_j == 0, qe, 0)
    q_if1 = jnp.where(a_j == 1, qe, 0)
    e0 = q_if1 - q_if0
    sum_q0 = jnp.sum(q_if0, axis=-1, dtype=jnp.int32)
    sum_q1 = jnp.sum(q_if1, axis=-1, dtype=jnp.int32)
    D2 = jnp.stack([sum_q0, sum_q1, sum_q1, sum_q0], axis=-1)
    m0 = jnp.sum(jnp.minimum(delta, 0), axis=-1, dtype=jnp.int32)
    mp = jnp.sum(jnp.minimum(delta + e0[:, None, :], 0), axis=-1,
                 dtype=jnp.int32)
    mm = jnp.sum(jnp.minimum(delta - e0[:, None, :], 0), axis=-1,
                 dtype=jnp.int32)
    base = cost - m0
    cand_cost = jnp.stack([
        base + D2[:, 0:1] + mp, base + D2[:, 1:2] + mm,
        base + D2[:, 2:3] + m0, base + D2[:, 3:4] + m0], axis=-1)
    choice_ids = jax.lax.broadcasted_iota(jnp.int32, (B, W, 4), 2)
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (B, W, 4), 1)
    het_inc = jnp.where(skip[:, None, None], 0, 1 - (choice_ids >> 1))
    cand_hets = hets[:, :, None] + het_inc
    identical = hets == 0
    cand_valid = jnp.broadcast_to(valid[:, :, None], (B, W, 4))
    cand_valid &= ~(identical[:, :, None] & (choice_ids == 1))
    cand_valid &= (~skip[:, None, None]) | (choice_ids == 0)
    order_bits = order_bits_for(beam_width)
    hets_cap = max_hets_for(beam_width)
    order = slot_ids * 4 + choice_ids
    k_cost = jnp.where(cand_valid, cand_cost, BIG).reshape(B, W * 4)
    k_sec = ((hets_cap - cand_hets) << order_bits | order).reshape(B, W * 4)
    if variant == "snosort":
        new_cost, sec = k_cost[:, :beam_width], k_sec[:, :beam_width]
    else:
        sorted_cost, sorted_sec = jax.lax.sort((k_cost, k_sec), num_keys=2)
        new_cost = sorted_cost[:, :beam_width]
        sec = sorted_sec[:, :beam_width]
    sel_flat = sec & ((1 << order_bits) - 1)
    sel_parent = sel_flat >> 2
    sel_choice = sel_flat & 3
    new_hets = hets_cap - (sec >> order_bits)
    new_valid = new_cost < BIG
    bidx = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
    if variant == "snogath":
        new_delta = delta
    else:
        pdelta = delta[bidx, sel_parent]
        sgn = jnp.where(sel_choice == 0, 1,
                        jnp.where(sel_choice == 1, -1, 0))
        nd = pdelta + sgn[:, :, None] * e0[:, None, :]
        nd = jnp.where(reset_next[:, None, :], 0, nd)
        new_delta = nd.astype(delta.dtype)
    return ((new_delta, new_cost, new_hets, new_valid),
            (sel_parent.astype(jnp.int16), sel_choice.astype(jnp.int8)))


if __name__ == "__main__":
    sys.exit(main())
