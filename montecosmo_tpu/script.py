"""Inference orchestration: the 3-phase field-level pipeline with file-based
idempotent resume.

Phase 1 `field_warmup`  : sample only the initial field (all other latents at
                          fiducial), chains started from the analytic Kaiser
                          posterior, MCLMC-tuned per chain.
Phase 2 `full_warmup`   : tune every latent, seeding the field from phase 1;
                          tuned configs collapse to one shared median config
                          with L set from the evals/ESS target.
Phase 3 `full_run`      : n_runs x n_samples thinned MCLMC samples, each run
                          saved as run_{i}.h5 + a resumable last state.

Every phase checks for its outputs and loads instead of recomputing — crash
recovery is file-based resume, with the RNG key advanced per completed run.

Parity: reference `montecosmo/script.py` (map_chains:13-20, field_warmup:
32-68, full_warmup:109-153, full_run:156-191, make_chains:197-306,
make_logdf_mesh:309-345, compare_chains:349-403).
"""
import os
from functools import partial
from pathlib import Path

import numpy as np
import jax
import jax.flatten_util
from jax import jit, numpy as jnp, random as jr, vmap

from montecosmo_tpu.parallel.chains import map_chains
from montecosmo_tpu.samplers import (
    IntegratorState, MCLMCAdaptationState, get_mams_run, get_mclmc_run,
    get_mclmc_warmup,
)
from montecosmo_tpu.samplers.mclmc import (
    MCLMCAdaptationState as _AdaptState, _warmup_carry0, _warmup_chunk,
    _warmup_finalize, mclmc_init,
)
from montecosmo_tpu.utils.io import h5load, h5load_tree, h5save, h5save_tree
from montecosmo_tpu.utils.profiling import phase

# Long scans are CHUNKED at the host level into device programs of at most
# this many MCLMC steps (0 = unchunked): each chunk boundary is a point at
# which progress is printed and the state can be checkpointed for resume.
# Warmup segments re-enter the tuner with the carried config; run chunks
# carry the integrator state exactly.
MAX_STEPS_PER_CALL = int(os.environ.get("MONTECOSMO_MAX_STEPS_PER_CALL", 128))


class _AdaptiveChunks:
    """Host-level adaptive program sizing for NUTS loops.

    NUTS step cost varies ~100x over a warmup (early max-depth trees vs
    tuned ~2^3-eval trees), so a fixed steps-per-program either makes the
    progress/checkpoint cadence hours long or spends the run on dispatching
    4-step programs.  This grows/shrinks the chunk size from measured wall
    time toward `MONTECOSMO_TARGET_SECS_PER_CALL` (default 15 s), on
    power-of-two rungs to bound recompiles.  The first run
    of each distinct size includes its compile and is never used for
    adaptation.  Chunk boundaries do not change trajectories (the scan
    carry is exact — tested bit-identical for the segmented warmups).
    """

    def __init__(self, seg0, cap, target_s=None):
        self.seg = max(1, int(seg0))
        self.cap = max(1, int(cap))
        self.target_s = float(target_s if target_s is not None else
                              os.environ.get(
                                  "MONTECOSMO_TARGET_SECS_PER_CALL", 15))
        self._timed = set()

    def next(self, remaining):
        return min(self.seg, int(remaining))

    def update(self, seg_i, elapsed):
        if seg_i not in self._timed:
            self._timed.add(seg_i)  # first run of a size includes compile
            return
        per_step = max(elapsed / seg_i, 1e-9)
        want = self.target_s / per_step
        want = min(want, 8.0 * self.seg)  # bound jumps against timing flukes
        rung = 2 ** int(np.floor(np.log2(max(want, 1.0))))
        self.seg = int(min(max(rung, 1), self.cap))


def _segmented_warmup(logpdf, n_steps, desired_energy_var, tune_mass,
                      n_chains, key, pos, ckpt_path=None):
    """MCLMC warmup chunked into <= MAX_STEPS_PER_CALL-step device programs.

    The adaptation carry is threaded across chunks, so the tuning trajectory
    is IDENTICAL to one monolithic warmup (same per-step keys): only the
    host/device dispatch boundary moves.

    `ckpt_path` enables mid-warmup checkpoint/resume: the carry is saved
    every MONTECOSMO_RUN_CKPT_EVERY chunks, and a rerun resumes at the
    last saved chunk with a bit-identical trajectory (the per-step keys are
    precomputed from the seed, so a restart replays the same schedule), so
    an interrupted 2^13-step warmup does not restart from zero.
    """
    if not MAX_STEPS_PER_CALL or n_steps <= MAX_STEPS_PER_CALL:
        fn = map_chains(get_mclmc_warmup(
            logpdf, n_steps=n_steps, config=None,
            desired_energy_var=desired_energy_var,
            diagonal_preconditioning=tune_mass), n_chains)
        return fn(jr.split(key, n_chains), pos)

    steps1 = n_steps // 2
    steps2 = n_steps - steps1

    def prep_keys(seed):  # mirrors mclmc_warmup's key bookkeeping exactly
        init_seed, tune_seed = jr.split(seed, 2)
        k1, k2 = jr.split(tune_seed)
        return init_seed, jr.split(k1, steps1), jr.split(k2, steps2)

    seeds = jr.split(key, n_chains)
    init_seeds, keys1, keys2 = jit(vmap(prep_keys))(seeds)

    def init_carry(init_seed, p):
        state = mclmc_init(p, logpdf, init_seed)
        flat = jax.flatten_util.ravel_pytree(state.position)[0]
        d = flat.shape[0]
        config = _AdaptState(jnp.asarray(d**0.5, flat.dtype),
                             jnp.asarray(d**0.5 / 1e4, flat.dtype),
                             inverse_mass_matrix=jnp.ones(d, flat.dtype))
        return _warmup_carry0(state, config, flat.dtype, d)

    carry = jit(vmap(init_carry))(init_seeds, pos)
    # surface the f32 energy-noise floor (mclmc._warmup_chunk clamps the
    # per-dim target to it): operators should know the requested target is
    # unreachable at this |logpdf| rather than read it off a frozen chain
    _d = carry[1].inverse_mass_matrix.shape[-1]
    _eps = float(jnp.finfo(carry[1].step_size.dtype).eps)
    _labs = float(np.abs(np.asarray(carry[0].logdensity)).max())
    _floor = 25.0 * (2.0 * _eps * _labs) ** 2 / 6.0 / _d
    if _floor > desired_energy_var:
        print(f"  warmup: f32 energy-noise floor {_floor:.1e}/dim exceeds "
              f"desired_energy_var {desired_energy_var:.1e} — tuner clamped "
              f"to the floor (|logpdf| ~ {_labs:.2e}, d={_d})", flush=True)
    chunk1 = jit(vmap(partial(
        _warmup_chunk, stream_moments=False, logdf=logpdf,
        desired_energy_var=desired_energy_var)))
    chunk2 = jit(vmap(partial(
        _warmup_chunk, stream_moments=True, logdf=logpdf,
        desired_energy_var=desired_energy_var)))

    plan, i = [], 0  # (phase, key offset, length) per chunk
    for seg in _segments(steps1, MAX_STEPS_PER_CALL):
        plan.append((1, i, seg))
        i += seg
    i = 0
    for seg in _segments(steps2, MAX_STEPS_PER_CALL):
        plan.append((2, i, seg))
        i += seg

    start_chunk, done_steps = 0, 0
    ckpt_path = Path(ckpt_path) if ckpt_path else None
    ckpt_every = int(os.environ.get("MONTECOSMO_RUN_CKPT_EVERY", 8))
    if ckpt_path is not None and ckpt_path.exists():
        try:
            saved = h5load(ckpt_path)
            start_chunk = int(np.asarray(saved["_n_chunk"]))
            leaves = [saved[f"l{j}"]
                      for j in range(len(jax.tree.leaves(carry)))]
            carry = jax.tree.unflatten(jax.tree.structure(carry), leaves)
            done_steps = sum(seg for _, _, seg in plan[:start_chunk])
            print(f"  warmup: resuming at chunk {start_chunk} "
                  f"({done_steps}/{n_steps} steps)", flush=True)
        except (OSError, KeyError) as exc:  # interrupted mid-write
            print(f"  warmup: unreadable checkpoint ({exc}); restarting",
                  flush=True)
            start_chunk, done_steps = 0, 0
            ckpt_path.unlink()

    import time as _time
    for n_chunk, (ph, off, seg) in enumerate(plan):
        if n_chunk < start_chunk:
            continue
        fn, keys = (chunk1, keys1) if ph == 1 else (chunk2, keys2)
        _t0 = _time.time()
        carry = fn(carry, keys=keys[:, off:off + seg])
        # transfer a scalar every chunk: waits for the chunk (honest chunk
        # timings, and a device failure surfaces at the offending chunk)
        _ss = np.asarray(carry[1].step_size)
        done_steps += seg
        print(f"  warmup: {done_steps}/{n_steps} steps "
              f"({_time.time() - _t0:.1f}s/chunk, ss {_ss.mean():.2e})",
              flush=True)
        if (ckpt_path is not None and ckpt_every
                and (n_chunk + 1) % ckpt_every == 0
                and n_chunk + 1 < len(plan)):
            # atomic replace: an interrupted write must not corrupt the resume
            tmp = ckpt_path.with_suffix(".tmp.h5")
            h5save(tmp, {"_n_chunk": np.int64(n_chunk + 1),
                         **{f"l{j}": v for j, v in
                            enumerate(jax.tree.leaves(carry))}})
            os.replace(tmp, ckpt_path)
    out = jit(vmap(partial(_warmup_finalize,
                           diagonal_preconditioning=tune_mass)))(carry)
    if ckpt_path is not None and ckpt_path.exists():
        ckpt_path.unlink()  # the final state supersedes the checkpoint
    return out


def _segments(n_steps, max_steps):
    if not max_steps or n_steps <= max_steps:
        return [n_steps]
    n_seg = -(-n_steps // max_steps)
    base = n_steps // n_seg
    sizes = [base] * n_seg
    for i in range(n_steps - base * n_seg):
        sizes[i] += 1
    return sizes


def _segmented_mams_warmup(logpdf, n_steps, tune_mass, n_chains, key, pos):
    """MAMS (adjusted MCLMC) warmup chunked into short device programs.

    The Robbins-Monro carry and the global step indices are threaded across
    chunks, so the tuning trajectory is identical to one monolithic scan."""
    from montecosmo_tpu.samplers.mclmc import (
        _mams_carry0, _mams_chunk, _mams_finalize,
    )

    def prep(seed):  # mirrors mams_warmup's key bookkeeping exactly
        init_seed, tune_seed = jr.split(seed, 2)
        return init_seed, jr.split(tune_seed, n_steps)

    init_seeds, keys = jit(vmap(prep))(jr.split(key, n_chains))

    def init_carry(init_seed, p):
        state = mclmc_init(p, logpdf, init_seed)
        flat = jax.flatten_util.ravel_pytree(state.position)[0]
        d = flat.shape[0]
        config = _AdaptState(jnp.asarray(d**0.5, flat.dtype),
                             jnp.asarray(d**0.5 / 64, flat.dtype),
                             inverse_mass_matrix=jnp.ones(d, flat.dtype))
        return _mams_carry0(state, config, flat.dtype, d)

    carry = jit(vmap(init_carry))(init_seeds, pos)
    chunk = jit(vmap(partial(_mams_chunk, logdf=logpdf)))
    idx = jnp.arange(n_steps)
    i = 0
    for seg in _segments(n_steps, MAX_STEPS_PER_CALL):
        ids = jnp.broadcast_to(idx[i:i + seg], (n_chains, seg))
        carry = chunk(carry, xs=(ids, keys[:, i:i + seg]))
        i += seg
    return jit(vmap(partial(_mams_finalize,
                            diagonal_preconditioning=tune_mass)))(carry)


def _nuts_blocks(names):
    """Default NUTS-within-Gibbs block split: field vs scalars, empty blocks
    dropped (e.g. a fully observed field leaves plain NUTS on the scalars)."""
    mesh_keys = [k for k in names if k.endswith("mesh_")]
    rest_keys = [k for k in names if k not in mesh_keys]
    blocks = {}
    if mesh_keys:
        blocks["mesh_"] = mesh_keys
    if rest_keys:
        blocks["rest_"] = rest_keys
    return blocks


def _segmented_nuts_warmup(logpdf, n_steps, n_chains, key, pos,
                           initial_step_size=None, target=0.8,
                           initial_inverse_mass_matrix=None, ckpt_path=None):
    """Blocked NUTS window adaptation (Stan fast/slow/fast schedule), chunked
    into short device programs along the precomputed schedule.

    `initial_step_size=None` (default) brackets a per-chain starting step size
    with `find_reasonable_step_size` (~10 gradient evals) instead of starting
    dual averaging blind at 1e-3 — a blind cold start makes every early tree
    hit max depth (2^max_depth evals/step), which dominated warmup wall time.
    `initial_inverse_mass_matrix` optionally seeds per-block diagonal masses
    (dict block name -> flat (d,) or (n_chains, d) vector), e.g. from the
    MCLMC phase-1 chain spread.  Device programs are sized adaptively from
    measured wall time (`_AdaptiveChunks`).

    `ckpt_path` enables mid-warmup checkpoint/resume (one file per Gibbs
    block, derived from the stem): the adaptation carry is saved every
    MONTECOSMO_RUN_CKPT_EVERY steps/chunks and at block completion, and a
    rerun resumes bit-identically (per-step keys and the window schedule are
    precomputed from the seed), so an interrupted N-body NUTS warmup, which
    can run for hours, does not restart from zero.

    Returns (state: {block: HMCState} batched over chains,
             config: {block: {step_size, inverse_mass_matrix}},
             n_evals: total integration steps)."""
    from montecosmo_tpu.samplers.hmc import (
        _adaptation_schedule, _wa_carry0, _wa_chunk, _wa_finalize,
        find_reasonable_step_size, nuts_kernel,
    )

    blocks = _nuts_blocks(list(pos))
    update_now, in_slow = _adaptation_schedule(n_steps)
    update_now = jnp.asarray(update_now)
    in_slow = jnp.asarray(in_slow, jnp.result_type(float))

    block_keys = {name: jit(vmap(lambda s: jr.split(s, n_steps)))(
        jr.split(jr.fold_in(key, i), n_chains))
        for i, name in enumerate(blocks)}

    ckpt_path = Path(ckpt_path) if ckpt_path else None
    ckpt_every = int(os.environ.get("MONTECOSMO_RUN_CKPT_EVERY", 8))

    def _bckpt(name):
        return (ckpt_path.parent / f"{ckpt_path.stem}_{name}.h5"
                ) if ckpt_path is not None else None

    def _save_carry(path, carry, i, evals):
        # atomic replace: an interrupted write must not corrupt the resume
        tmp = path.with_suffix(".tmp.h5")
        h5save(tmp, {"_i": np.int64(i), "_evals": np.float64(evals),
                     **{f"l{j}": v
                        for j, v in enumerate(jax.tree.leaves(carry))}})
        os.replace(tmp, path)

    state, config = {}, {}
    others = dict(pos)  # running per-chain values of the not-yet-warmed blocks
    n_evals = 0.0
    for i_block, (name, keys) in enumerate(blocks.items()):
        p_block = {k: others[k] for k in blocks[name]}
        rest = {k: v for k, v in others.items() if k not in blocks[name]}

        bckpt = _bckpt(name)
        start_i, saved_leaves = 0, None
        if bckpt is not None and bckpt.exists():
            try:
                saved_leaves = h5load(bckpt)
                start_i = int(np.asarray(saved_leaves["_i"]))
                n_evals = float(np.asarray(saved_leaves["_evals"]))
            except (OSError, KeyError) as exc:  # interrupted mid-write
                print(f"  nuts warmup [{name}]: unreadable checkpoint "
                      f"({exc}); restarting block", flush=True)
                start_i, saved_leaves = 0, None
                bckpt.unlink()

        # metric selection: small scalar blocks get a DENSE mass (full
        # Welford covariance in slow windows) — the cosmology/bias scalars
        # are strongly correlated (Omega_m-sigma8-b1 degeneracies), and a
        # diagonal metric forces every tree to the depth cap (measured 126
        # evals/step for a 3-scalar block at 32^3 N-body); mesh blocks stay
        # diagonal (d ~ 10^5-10^7)
        d_block = int(sum(np.prod(v.shape[1:]) for v in p_block.values()))
        dense_max = int(os.environ.get("MONTECOSMO_NUTS_DENSE_MAX", 64))
        use_dense = not name.startswith("mesh") and 0 < d_block <= dense_max

        invmm0 = (initial_inverse_mass_matrix or {}).get(name)
        if invmm0 is None:
            invmm0 = jnp.broadcast_to(
                jnp.eye(d_block), (n_chains, d_block, d_block)) \
                if use_dense else jnp.ones((n_chains,))
        else:
            invmm0 = jnp.asarray(invmm0)
            if invmm0.ndim == 2 and invmm0.shape == (d_block, d_block) \
                    and d_block != n_chains:
                # shared dense seed (e.g. a Laplace inverse Hessian)
                invmm0 = jnp.broadcast_to(
                    invmm0 if use_dense else jnp.diag(invmm0),
                    (n_chains, *((d_block, d_block) if use_dense
                                 else (d_block,))))
            elif invmm0.ndim <= 1:  # scalar or shared (d,) diagonal
                if use_dense:
                    diag = jnp.broadcast_to(invmm0, (d_block,))
                    invmm0 = jnp.broadcast_to(
                        jnp.diag(diag), (n_chains, d_block, d_block))
                else:
                    invmm0 = jnp.broadcast_to(invmm0,
                                              (n_chains, *invmm0.shape))
            elif invmm0.ndim == 2 and use_dense:  # per-chain (C, d) diagonal
                invmm0 = jit(vmap(jnp.diag))(invmm0)

        def _bracket_eps0():
            nonlocal n_evals
            if initial_step_size is not None:
                return jnp.broadcast_to(jnp.asarray(initial_step_size),
                                        (n_chains,))
            eps_keys = jr.split(jr.fold_in(key, 1000 + i_block), n_chains)
            if MAX_STEPS_PER_CALL:
                # host-chunked search: one gradient eval per device program
                # (a whole bracket in one program runs minutes on expensive
                # models)
                from montecosmo_tpu.samplers.hmc import (
                    bracket_final, bracket_init, bracket_iter,
                )

                def br_init(p, other, k, im):
                    return bracket_init(lambda v: logpdf({**other, **v}),
                                        p, k, inverse_mass_matrix=im)

                def br_iter(p, other, carry):
                    return bracket_iter(lambda v: logpdf({**other, **v}),
                                        p, carry)

                carry_b = jit(vmap(br_init))(p_block, rest, eps_keys, invmm0)
                iter_jit = jit(vmap(br_iter))
                n_evals += 2.0 * n_chains  # init + first probe
                for _ in range(30):  # max_iters
                    more = np.asarray(carry_b["more"])  # forces execution
                    if not more.any():
                        break
                    carry_b = iter_jit(p_block, rest, carry_b)
                    n_evals += float(more.sum())
                eps0 = jit(vmap(bracket_final))(carry_b)
            else:
                def bracket(p, other, k, im):
                    return find_reasonable_step_size(
                        lambda v: logpdf({**other, **v}), p, k,
                        inverse_mass_matrix=im)
                eps0 = jit(vmap(bracket))(p_block, rest, eps_keys, invmm0)
                n_evals += 12.0 * n_chains  # bracket cost (<= max_iters+2)
            print(f"  nuts warmup [{name}] bracketed step size: "
                  f"{np.asarray(eps0).round(5)}", flush=True)
            return eps0

        eps0 = None if start_i else _bracket_eps0()

        def carry0(p, other, eps, im):
            return _wa_carry0(lambda v: logpdf({**other, **v}), p, eps, im)

        def chunk(carry, xs, other):
            return _wa_chunk(carry, xs, nuts_kernel,
                             lambda v: logpdf({**other, **v}),
                             target_acceptance_rate=target)

        import time as _time

        if start_i:
            # rebuild the carry pytree from the checkpoint: eval_shape gives
            # the treedef without running the model
            tmpl = jax.eval_shape(
                vmap(carry0), p_block, rest,
                jax.ShapeDtypeStruct((n_chains,), invmm0.dtype), invmm0)
            t_leaves = jax.tree.leaves(tmpl)
            try:
                leaves = [jnp.asarray(saved_leaves[f"l{j}"])
                          for j in range(len(t_leaves))]
                if any(l.shape != t.shape
                       for l, t in zip(leaves, t_leaves)):
                    raise KeyError("checkpoint/carry shape mismatch")
            except KeyError as exc:
                # e.g. the metric env flag changed between run and resume:
                # the checkpoint no longer matches — restart the block
                print(f"  nuts warmup [{name}]: stale checkpoint ({exc}); "
                      f"restarting block", flush=True)
                start_i = 0
                bckpt.unlink()
                eps0 = _bracket_eps0()
        if start_i:
            carry = jax.tree.unflatten(jax.tree.structure(tmpl), leaves)
            print(f"  nuts warmup [{name}] resuming at {start_i}/{n_steps}",
                  flush=True)
        else:
            carry = jit(vmap(carry0))(p_block, rest, eps0, invmm0)
        host_m = int(os.environ.get("MONTECOSMO_NUTS_EVALS_PER_PROGRAM", 0))
        if host_m:
            # sub-step host chunking: on expensive models (N-body at >= 64^3)
            # a SINGLE NUTS step runs for minutes, so the doubling/leaf loops
            # run at the host level — identical
            # transition (tests/test_nuts_host.py), identical adaptation
            # (shared _wa_post)
            from montecosmo_tpu.samplers.hmc import (
                _wa_post, nuts_host_transition)

            pos_like = jax.tree.map(lambda v: v[0], p_block)
            trans = nuts_host_transition(
                lambda v, other: logpdf({**other, **v}), pos_like,
                evals_per_program=host_m)
            p_post = jit(vmap(partial(_wa_post,
                                      target_acceptance_rate=target)))
            p_ss = jit(vmap(lambda da: jnp.exp(da.log_eps)))
            for i in range(start_i, n_steps):
                _t0 = _time.time()
                state_b, da, invmm_b, welford = carry
                state_b, info = trans(block_keys[name][:, i], state_b,
                                      p_ss(da), invmm_b, rest)
                carry = p_post(
                    (state_b, da, invmm_b, welford), info,
                    jnp.broadcast_to(update_now[i], (n_chains,)),
                    jnp.broadcast_to(in_slow[i], (n_chains,)))
                n_evals += float(jnp.sum(info["num_integration_steps"]))
                if (i + 1) % 8 == 0 or i + 1 == n_steps:
                    print(f"  nuts warmup [{name}] {i + 1}/{n_steps} "
                          f"({_time.time() - _t0:.1f}s/step, "
                          f"{float(jnp.sum(info['num_integration_steps'])):.0f} evals)",
                          flush=True)
                if bckpt is not None and ckpt_every and (
                        (i + 1) % ckpt_every == 0 or i + 1 == n_steps):
                    _save_carry(bckpt, carry, i + 1, n_evals)
        else:
            chunk_jit = jit(vmap(chunk))  # hoisted: 1 compile per segment size
            chunks = _AdaptiveChunks(max(1, MAX_STEPS_PER_CALL // 32),
                                     cap=max(MAX_STEPS_PER_CALL, 1))
            i, n_chunk = start_i, 0
            while i < n_steps:
                seg = chunks.next(n_steps - i)
                _t0 = _time.time()
                xs = (block_keys[name][:, i:i + seg],
                      jnp.broadcast_to(update_now[i:i + seg], (n_chains, seg)),
                      jnp.broadcast_to(in_slow[i:i + seg], (n_chains, seg)))
                carry, hist = chunk_jit(carry, xs, rest)
                # the float() transfer waits for the chunk: honest timing
                n_evals += float(jnp.sum(hist["num_integration_steps"]))
                _dt = _time.time() - _t0
                i += seg
                chunks.update(seg, _dt)
                n_chunk += 1
                print(f"  nuts warmup [{name}] {i}/{n_steps} "
                      f"({_dt:.1f}s, next chunk {chunks.seg})", flush=True)
                if bckpt is not None and ckpt_every and (
                        n_chunk % ckpt_every == 0 or i >= n_steps):
                    _save_carry(bckpt, carry, i, n_evals)
        state[name], config[name] = jit(vmap(_wa_finalize))(carry)
        others = {**others, **state[name].position}

    if ckpt_path is not None:  # the finalized state supersedes the ckpts
        for name in blocks:
            b = _bckpt(name)
            if b.exists():
                b.unlink()
    return state, config, n_evals


def field_warmup(model, chains_dir, n_steps, desired_energy_var, n_chains,
                 scale_field=7 / 8, seed=43, overwrite=False):
    """Field-only warmup: fix every latent to fiducial, condition on the
    observed counts, tune MCLMC on the initial field.

    Returns (state, config, params_start); the model is left conditioned.
    """
    chains_dir = Path(chains_dir)
    chains_dir.mkdir(parents=True, exist_ok=True)
    state_path = chains_dir / "field_warm_state.h5"
    conf_path = chains_dir / "field_warm_conf.h5"

    model.reset()
    model.substitute(model.fiduc | model.obs_data(), from_base=True)
    model.block()

    params_start = jit(vmap(partial(model.kaiser_post, scale_field=scale_field)))(
        jr.split(jr.key(45), n_chains))
    print("\nField warmup params:", list(params_start))

    if not state_path.exists() or overwrite:
        print("Field warmup...")
        with phase("field_warmup"):
            state, config = _segmented_warmup(
                model.logpdf, n_steps, desired_energy_var, False, n_chains,
                jr.key(seed), params_start,
                ckpt_path=chains_dir / "field_warm_ckpt.h5")
        h5save_tree(state_path, state)
        h5save_tree(conf_path, config)
    else:
        print("Loading field warmup...")
        state = h5load_tree(state_path, IntegratorState)
        config = h5load_tree(conf_path, MCLMCAdaptationState)
    return state, config, params_start


def plot_field_warmup(model, params_start, state, save_dir, prob=(0.68, 0.95)):
    """Power/transfer/coherence of the warmup chains vs the true ICs."""
    import matplotlib.pyplot as plt
    from montecosmo_tpu.plot import plot_pow, plot_powtranscoh, plot_trans

    save_dir = Path(save_dir)
    white_mesh = model.white_mesh
    # jit everything: unjitted vmaps dispatch op-by-op.  white_mesh is an
    # ARGUMENT, not a closure capture, so that the whitened ICs are not
    # embedded in the program as a constant
    kptc_fn = jit(vmap(lambda x, wm: model.powtranscoh(
        wm, model.reparam(x)["white_mesh"]), in_axes=(0, None)))
    kptcs_start = jax.tree.map(np.asarray, kptc_fn(params_start, white_mesh))
    kptcs_warm = jax.tree.map(np.asarray, kptc_fn(state.position, white_mesh))
    kpow_true = jax.tree.map(np.asarray, jit(model.spectrum)(white_mesh))
    # whitened ICs -> the theoretical reference is flat unit power
    kpow_fid = kptcs_warm[0][0], np.ones_like(kptcs_warm[0][0])

    plt.figure(figsize=(12, 4), layout="constrained")

    def plot_kptcs(kptcs, label=None):
        plot_powtranscoh(*kptcs, fill=prob)
        plot_powtranscoh(*jax.tree.map(lambda x: np.median(x, 0), kptcs),
                         label=label)

    plot_kptcs(kptcs_start, label="start")
    plot_kptcs(kptcs_warm, label="warm")

    plt.subplot(131)
    plot_pow(*kpow_true, "k:", label="true")
    plot_pow(*kpow_fid, "k--", alpha=0.5, label="fiducial")
    plt.legend()
    plt.subplot(132)
    plt.axhline(1.0, linestyle=":", color="k", alpha=0.5)
    plot_trans(kpow_true[0], (kpow_fid[1] / kpow_true[1]) ** 0.5, "k--",
               alpha=0.5, label="fiducial")
    plt.subplot(133)
    plt.axhline(float(np.mean(np.asarray(model.selec_mesh))), linestyle=":",
                color="k", alpha=0.5)
    plt.savefig(save_dir / "field_warm.png", dpi=300)
    plt.close()


def _laplace_seed(logpdf, p_block, others):
    """Dense inverse-mass seed for a small parameter block: the inverse of
    the (PSD-ified) conditional Hessian of -logpdf at the current point.

    The Hessian is built column-by-column with forward-over-reverse HVPs —
    each column is its own short jitted device program, so the cost is
    d x ~2.5 model evals, negligible next to the max-depth trees it removes.
    Saddle directions are handled with the |eigenvalue| trick; the spectrum
    is floored at 1e-6 of the largest curvature (condition cap 1e6).
    """
    flat0, unravel = jax.flatten_util.ravel_pytree(p_block)
    d = flat0.shape[0]

    def lp_flat(f):
        return logpdf({**others, **unravel(f)})

    gfn = jax.grad(lp_flat)
    hvp = jit(lambda v: jax.jvp(gfn, (flat0,), (v,))[1])
    cols = []
    for i in range(d):
        e = jnp.zeros_like(flat0).at[i].set(1.0)
        cols.append(np.asarray(hvp(e)))  # transfer: one program per column
    hess = -np.stack(cols, axis=1).astype(np.float64)  # precision of logpdf
    hess = 0.5 * (hess + hess.T)
    if not np.all(np.isfinite(hess)):
        raise FloatingPointError("non-finite Hessian at warm start")
    try:
        w, v = np.linalg.eigh(hess)
    except np.linalg.LinAlgError:
        # LAPACK non-convergence on extreme-conditioned Hessians (killed the
        # round-4 nuts32 campaign): equilibrate to unit diagonal and retry —
        # with H = S A S, S = diag(sqrt|diag H|), the PSD-ified inverse of H
        # is S^-1 (v |w|^-1 v^T) S^-1 from the eigensystem of A
        s = np.sqrt(np.maximum(np.abs(np.diag(hess)), 1e-30))
        w, v = np.linalg.eigh(hess / np.outer(s, s))
        wa = np.maximum(np.abs(w), 1e-6 * max(np.abs(w).max(), 1e-30))
        cov = ((v / wa) @ v.T) / np.outer(s, s)
        return (jnp.asarray(0.5 * (cov + cov.T), jnp.result_type(float)),
                wa * float(np.median(s)) ** 2)
    w = np.abs(w)
    w = np.maximum(w, 1e-6 * max(w.max(), 1e-30))
    cov = (v / w) @ v.T
    return jnp.asarray(0.5 * (cov + cov.T), jnp.result_type(float)), w


def full_warmup(model, obs, state_field, chains_dir, n_steps, desired_energy_var,
                n_chains, tune_mass, eval_per_ess=1e3, seed=43, overwrite=False,
                sampler="mclmc"):
    """Full warmup: condition on `obs`, tune every other latent, seed the
    field from the field-warmup state.

    sampler='mclmc' : MCLMC energy-variance tuner; tuned configs collapse to
      the shared median config with L = 0.4 * (eval_per_ess / 2) * step_size.
    sampler='mams'  : Robbins-Monro acceptance tuner (target 0.65); median
      collapse of (L, step_size, invmm), no eval/ESS L override (adjusted
      chains need no implicit-thinning L).
    sampler='nuts'  : blocked Stan window adaptation; median collapse of the
      per-block (step_size, invmm).
    """
    chains_dir = Path(chains_dir)
    chains_dir.mkdir(parents=True, exist_ok=True)
    state_path = chains_dir / "full_warm_state.h5"
    conf_path = chains_dir / "full_warm_conf.h5"

    model.reset()
    model.substitute(obs | model.obs_data(), from_base=True)
    model.block()

    if not state_path.exists() or overwrite:
        print("\nFull warmup...")
        params_warm = jit(vmap(model.kaiser_post))(jr.split(jr.key(45), n_chains))
        if "white_mesh" not in model.data:
            params_warm |= state_field.position
        print("Full warmup params:", list(params_warm))

        if sampler == "nuts":
            # seed the mesh-block mass from the MCLMC phase-1 chain spread:
            # the per-dim cross-chain variance of approximately-stationary
            # draws is a (noisy) posterior-variance estimate, refreshed by
            # the first slow window anyway — but it spares the first fast
            # window from unit-mass trees on a field whose posterior scales
            # are far from 1 (data-constrained modes have std << 1).
            seed_invmm = None
            if state_field is not None and "white_mesh" not in model.data \
                    and n_chains > 1:
                mesh_keys = sorted(k for k in state_field.position
                                   if k.endswith("mesh_"))
                if mesh_keys:
                    x = jit(vmap(lambda p: jax.flatten_util.ravel_pytree(p)[0])
                            )({k: state_field.position[k] for k in mesh_keys})
                    var = jnp.var(x, axis=0)
                    nc = float(n_chains)  # Stan-style shrinkage for few chains
                    seed_invmm = {"mesh_": var * nc / (nc + 5.0)
                                  + 1e-3 * 5.0 / (nc + 5.0)}
            # Laplace-seed the scalar block: the conditional Hessian at the
            # warm start is exactly the right preconditioner for the Gibbs
            # rest_ block (it samples conditionally on the field), and it
            # captures the Omega_m/sigma8/b1 CORRELATIONS a diagonal seed
            # cannot — without it the first windows burn max-depth trees
            # (observed: 126 evals/step for 200 steps at 32^3 N-body)
            rest_keys = [k for k in params_warm if not k.endswith("mesh_")]
            d_rest = int(sum(np.prod(np.shape(params_warm[k])[1:])
                             for k in rest_keys))
            if rest_keys and 0 < d_rest <= 64 and \
                    os.environ.get("MONTECOSMO_NUTS_LAPLACE_SEED", "1") != "0":
                p0 = {k: jnp.asarray(params_warm[k][0]) for k in rest_keys}
                o0 = {k: jnp.asarray(v[0]) for k, v in params_warm.items()
                      if k not in rest_keys}
                try:
                    cov, w = _laplace_seed(model.logpdf, p0, o0)
                    seed_invmm = dict(seed_invmm or {})
                    seed_invmm["rest_"] = cov
                    print(f"  nuts warmup [rest_] Laplace-seeded mass "
                          f"({d_rest} dims, curvature "
                          f"{w.min():.3g}..{w.max():.3g})", flush=True)
                except (np.linalg.LinAlgError, FloatingPointError,
                        jax.errors.JaxRuntimeError) as exc:
                    # a failed seed must never stop a campaign — window
                    # adaptation re-estimates the mass anyway
                    print(f"  nuts warmup [rest_] Laplace seed failed "
                          f"({str(exc).splitlines()[0][:100]}); falling back "
                          f"to unit mass", flush=True)
            with phase("full_warmup"):
                state, config, n_evals = _segmented_nuts_warmup(
                    model.logpdf, n_steps, n_chains, jr.key(seed), params_warm,
                    initial_inverse_mass_matrix=seed_invmm,
                    ckpt_path=chains_dir / "full_warm_ckpt.h5")
            print(f"\nNUTS warmup n_evals: {n_evals:.3g}")
            for name, conf in config.items():
                ss = jnp.median(conf["step_size"])
                invmm = jnp.median(conf["inverse_mass_matrix"], 0)
                if jnp.ndim(invmm) == 2:
                    # elementwise median of PSD matrices need not be PSD:
                    # symmetrize + eigenvalue floor before sharing it out
                    m = np.asarray(invmm, np.float64)
                    m = 0.5 * (m + m.T)
                    w, v = np.linalg.eigh(m)
                    w = np.maximum(w, 1e-8 * max(w.max(), 1e-30))
                    invmm = jnp.asarray((v * w) @ v.T, invmm.dtype)
                config[name] = {
                    "step_size": jnp.broadcast_to(ss, (n_chains,)),
                    "inverse_mass_matrix": jnp.broadcast_to(
                        invmm, (n_chains, *invmm.shape))}
                print(f"block {name}: ss {float(ss):.3e}, "
                      f"invmm mean {float(invmm.mean()):.3e}")
            _save_nuts_state(state_path, state)
            h5save_tree(conf_path, config)
            return state, config

        with phase("full_warmup"):
            if sampler == "mams":
                state, config = _segmented_mams_warmup(
                    model.logpdf, n_steps, tune_mass, n_chains,
                    jr.key(seed), params_warm)
            else:
                state, config = _segmented_warmup(
                    model.logpdf, n_steps, desired_energy_var, tune_mass,
                    n_chains, jr.key(seed), params_warm,
                    ckpt_path=chains_dir / "full_warm_ckpt.h5")
        print_mclmc_config(config, state)

        ss = jnp.median(config.step_size)
        invmm = config.inverse_mass_matrix
        invmm = jnp.median(invmm, 0) if jnp.ndim(invmm) > 1 else jnp.median(invmm)
        L = jnp.median(config.L) if sampler == "mams" \
            else 0.4 * eval_per_ess / 2 * ss
        config = MCLMCAdaptationState(L=L, step_size=ss,
                                      inverse_mass_matrix=invmm)
        config = jax.tree.map(
            lambda x: np.broadcast_to(np.asarray(x), (n_chains, *np.shape(x))),
            config)
        print_mclmc_config(config, state)

        h5save_tree(state_path, state)
        h5save_tree(conf_path, config)
    else:
        print("\nLoading full warmup...")
        if sampler == "nuts":
            state = _load_nuts_state(state_path)
            config = h5load(conf_path)
        else:
            state = h5load_tree(state_path, IntegratorState)
            config = h5load_tree(conf_path, MCLMCAdaptationState)
    return state, config


def _save_nuts_state(path, state):
    h5save_tree(path, state)


def _load_nuts_state(path):
    from montecosmo_tpu.samplers import HMCState

    raw = h5load(path)
    return {name: HMCState(**fields) for name, fields in raw.items()}


def full_run(model, state, config, chains_dir, n_samples, n_runs, n_chains,
             thinning=64, seed=42, overwrite=False, sampler="mclmc"):
    """Sampling runs with per-run HDF5 saves and last-state resume.

    sampler='mclmc'/'mams' carry (IntegratorState, MCLMCAdaptationState);
    'nuts' runs blocked NUTS-within-Gibbs sweeps (thinning ignored — every
    sweep is a kept sample)."""
    chains_dir = Path(chains_dir)
    chains_dir.mkdir(parents=True, exist_ok=True)
    last_path = chains_dir / "run_last_state.h5"

    start = 1
    if last_path.exists() and not overwrite:
        state = _load_nuts_state(last_path) if sampler == "nuts" \
            else h5load_tree(last_path, IntegratorState)
        while (chains_dir / f"run_{start}.h5").exists() and start <= n_runs:
            start += 1
        print(f"Resuming at run {start}...")

    print("Running...")
    if sampler == "nuts":
        # a sweep costs up to blocks x 2^depth evals: chunk a few per program
        max_samp = max(1, MAX_STEPS_PER_CALL // 32) if MAX_STEPS_PER_CALL \
            else n_samples
    elif sampler == "mams":
        # a kept sample is `thinning` trajectories of ~L/eps integration steps
        max_samp = max(1, MAX_STEPS_PER_CALL // max(1, 8 * thinning)) \
            if MAX_STEPS_PER_CALL else n_samples
    else:
        max_samp = max(1, MAX_STEPS_PER_CALL // max(1, thinning)) \
            if MAX_STEPS_PER_CALL else n_samples
    key = jr.key(seed)
    for _ in range(1, start):  # fresh randomness for resumed runs
        key, _ = jr.split(key, 2)

    # one jitted runner per distinct segment size (hoisted out of the run
    # loop: a fresh jit wrapper per call would recompile every chunk)
    _runners = {}

    def _make_runner(seg):
        if sampler == "nuts":
            host_m = int(os.environ.get(
                "MONTECOSMO_NUTS_EVALS_PER_PROGRAM", 0))
            if host_m:
                return _make_nuts_host_runner(model.logpdf, config, n_chains,
                                              seg, host_m)
            from montecosmo_tpu.samplers import nutswg_init
            from montecosmo_tpu.samplers.hmc import sampling_loop_general

            step_fn, init_fn, _, _ = nutswg_init(model.logpdf)

            def sweep(sd, st, cf):
                st, (union, infos) = sampling_loop_general(
                    sd, st, model.logpdf, step_fn, init_fn, cf, seg)
                return st, {**union,
                            "logdensity": infos["logdensity"],
                            "n_evals": infos["n_evals"]}

            batched = jit(vmap(sweep))
            return lambda key, st: batched(jr.split(key, n_chains), st, config)
        getter = get_mams_run if sampler == "mams" else get_mclmc_run
        run_fn = map_chains(getter(model.logpdf, seg, thinning=thinning,
                                   progress_bar=False), n_chains)
        return lambda key, st: run_fn(jr.split(key, n_chains), st, config)

    def run_segment(run_key, state, seg):
        if seg not in _runners:
            _runners[seg] = _make_runner(seg)
        return _runners[seg](run_key, state)

    # NUTS sweep cost varies with tree depth: size programs adaptively from
    # measured wall time (shared across runs, so later runs start tuned)
    sizer = _AdaptiveChunks(max_samp, cap=max(MAX_STEPS_PER_CALL, 1)) \
        if sampler == "nuts" else None

    import time as _time

    # mid-run checkpoint cadence: partial-run checkpoints let a rerun resume
    # INSIDE an interrupted run instead of redoing it from the top
    ckpt_every = int(os.environ.get("MONTECOSMO_RUN_CKPT_EVERY", 8))

    for i_run in range(start, n_runs + 1):
        print(f"run {i_run}/{n_runs}")
        key, run_key = jr.split(key, 2)
        part_path = chains_dir / f"run_{i_run}.partial.h5"
        pstate_path = chains_dir / f"run_{i_run}.pstate.h5"
        chunks, i, n_splits = [], 0, 0
        if part_path.exists() and pstate_path.exists() and not overwrite:
            try:
                saved = dict(h5load(part_path))
                i = int(np.asarray(saved.pop("_n_samples")))
                n_splits = int(np.asarray(saved.pop("_n_splits")))
                chunks = [saved]
                state = _load_nuts_state(pstate_path) if sampler == "nuts" \
                    else h5load_tree(pstate_path, IntegratorState)
                print(f"  run {i_run}: resuming mid-run at sample {i} "
                      f"({n_splits} chunks done)")
            except (OSError, KeyError) as exc:  # interrupted mid-write
                print(f"  run {i_run}: unreadable mid-run checkpoint "
                      f"({exc}); restarting the run", flush=True)
                chunks, i, n_splits = [], 0, 0
        for _ in range(n_splits):  # replay the chunk-key schedule
            run_key, _ = jr.split(run_key)

        def _ckpt():
            merged = jax.tree.map(
                lambda *xs: np.concatenate(xs, axis=1), *chunks) \
                if len(chunks) > 1 else chunks[0]
            # atomic replaces: an interrupted write must not corrupt the resume
            ptmp, stmp = (p.with_suffix(".tmp.h5")
                          for p in (part_path, pstate_path))
            if sampler == "nuts":
                _save_nuts_state(stmp, state)
            else:
                h5save_tree(stmp, state)
            h5save(ptmp, {**merged, "_n_samples": np.int64(i),
                          "_n_splits": np.int64(n_splits)})
            os.replace(stmp, pstate_path)
            os.replace(ptmp, part_path)
            return merged

        with phase("full_run"):
            since_ckpt = 0
            while i < n_samples:
                seg = sizer.next(n_samples - i) if sizer \
                    else min(max_samp, n_samples - i)
                run_key, k = jr.split(run_key)
                n_splits += 1
                _t0 = _time.time()
                state, part = run_segment(k, state, seg)
                # transfer every chunk to host immediately: waits for it
                # (honest timing), bounds the loss to one chunk if the run is
                # interrupted, and keeps the final concatenation off the device
                part = jax.tree.map(_to_savable, part)
                if sizer:
                    sizer.update(seg, _time.time() - _t0)
                i += seg
                chunks.append(part)
                since_ckpt += 1
                print(f"  run {i_run}: {i}/{n_samples} samples "
                      f"({_time.time() - _t0:.1f}s/chunk)", flush=True)
                if ckpt_every and since_ckpt >= ckpt_every and i < n_samples:
                    chunks, since_ckpt = [_ckpt()], 0
            samples = jax.tree.map(
                lambda *xs: np.concatenate(xs, axis=1), *chunks) \
                if len(chunks) > 1 else chunks[0]

        if "mse_per_dim" in samples:
            print("MSE per dim:", np.mean(samples["mse_per_dim"], 1), "\n")
        elif "acceptance_rate" in samples:
            print("acceptance:",
                  np.mean(samples["acceptance_rate"], 1), "\n")
        rtmp = chains_dir / f"run_{i_run}.tmp.h5"
        h5save(rtmp, dict(samples))
        os.replace(rtmp, chains_dir / f"run_{i_run}.h5")
        part_path.unlink(missing_ok=True)
        pstate_path.unlink(missing_ok=True)
        ltmp = last_path.with_suffix(".tmp.h5")
        if sampler == "nuts":
            _save_nuts_state(ltmp, state)
        else:
            h5save_tree(ltmp, state)
        os.replace(ltmp, last_path)
    return state


def _to_savable(v):
    from montecosmo_tpu.utils.io import to_np
    return to_np(v)


def _make_nuts_host_runner(logpdf, config, n_chains, seg, host_m):
    """NUTS-within-Gibbs sweeps via the HOST-driven transition: each
    <=host_m-leapfrog leaf chunk is its own device program, so expensive
    models (one eval > seconds) report progress and can be interrupted
    within a sweep.  Same sweep semantics as `sampling_loop_general` over
    `mwg_kernel_general` (per-sweep block re-init at the updated union, then
    one NUTS transition per block); per-sweep host transfers bound the loss
    to one sweep on an interruption.
    """
    from montecosmo_tpu.samplers.hmc import hmc_init, nuts_host_transition

    trans, p_binit = {}, {}

    def runner(key, st):
        names = list(st.keys())
        for k in names:
            if k not in trans:
                pos_like = jax.tree.map(lambda v: v[0], st[k].position)
                trans[k] = nuts_host_transition(
                    lambda v, other: logpdf({**other, **v}), pos_like,
                    evals_per_program=host_m)
                p_binit[k] = jit(vmap(
                    lambda pos, other: hmc_init(
                        pos, lambda v, _o=other: logpdf({**_o, **v}))))
        state = dict(st)
        sweep_keys = jit(vmap(lambda s: jr.split(s, seg)))(
            jr.split(key, n_chains))                         # (C, seg)
        parts = []
        for i in range(seg):
            bkeys = jit(vmap(lambda s: jr.split(s, len(names))))(
                sweep_keys[:, i])
            nev = np.zeros(n_chains)
            for j, k in enumerate(names):
                union = {}
                for kk in names:
                    union |= state[kk].position
                others = {kk: v for kk, v in union.items()
                          if kk not in state[k].position}
                # re-init the block at the updated union (1 eval program)
                state[k] = p_binit[k](state[k].position, others)
                state[k], info = trans[k](
                    bkeys[:, j], state[k], config[k]["step_size"],
                    config[k]["inverse_mass_matrix"], others)
                nev = nev + np.asarray(info["num_integration_steps"])
            union = {}
            for kk in names:
                union |= state[kk].position
            parts.append({**{kk: np.asarray(v) for kk, v in union.items()},
                          "logdensity": np.asarray(state[names[-1]].logdensity),
                          "n_evals": nev})
        part = jax.tree.map(lambda *xs: np.stack(xs, axis=1), *parts)
        return state, part

    return runner


# ---------------------------------------------------------------------------
# Chains post-processing
# ---------------------------------------------------------------------------
def make_chains(save_dir, start=1, end=100, thinning=1, reparb=False, prefix=""):
    """Load runs, reparametrize, compute field statistics, plot corner/trace
    panels, and save consolidated chain files. Runs with any ambient mesh
    context DEACTIVATED: a --spatial-mesh campaign enters mesh_context
    around the whole pipeline, and the pencil-FFT islands on the
    post-processing's small vmapped meshes trip an XLA:CPU fft-thunk layout
    assert (fft_thunk.cc:167)."""
    from montecosmo_tpu.parallel.context import mesh_context

    with mesh_context(None):
        return _make_chains(save_dir, start, end, thinning, reparb, prefix)


def _make_chains(save_dir, start=1, end=100, thinning=1, reparb=False,
                 prefix=""):
    import matplotlib.pyplot as plt
    from montecosmo_tpu.chains import Chains
    from montecosmo_tpu.models.model import FieldLevelModel
    from montecosmo_tpu.plot import (
        SetDark2, corner_plot, plot_coh, plot_pow, plot_powtranscoh, plot_trans,
    )
    from montecosmo_tpu.ops.hermitian import chreshape, r2chshape

    save_dir = Path(save_dir)
    chains_dir = save_dir / "chains"

    model = FieldLevelModel.load(save_dir / "model.yaml")
    obs = h5load(save_dir / "obs.h5")
    white_mesh = model.white_mesh
    infer_init = "white_mesh" not in obs
    markers = {k: float(v) for k, v in model.fiduc.items() if np.ndim(v) == 0}
    model.substitute(obs, from_base=True)

    transforms = [
        partial(Chains.thin, thinning=thinning),
        model.reparam_chains,
        partial(model.powtranscoh_chains,
                names="white_mesh" if infer_init else [], mesh0=white_mesh),
        partial(Chains.choice, n=10, names=["init", "init_"]),
    ]
    chains = model.load_runs(chains_dir, start, end, transforms=transforms,
                             batch_ndim=2)
    chains.save(chains_dir / f"{prefix}chains.h5")
    print(chains.shape, "\n")

    try:  # KDE can choke on degenerate samples; never kill postprocessing
        sel = chains.prune()[list(model.groups)
                             + (["~white_mesh"] if infer_init else [])]
        corner_plot(sel, markers=markers)
        plt.savefig(save_dir / f"{prefix}triangle.png", dpi=300)
        plt.close()
    except Exception as e:
        print(f"WARNING: triangle plot skipped ({type(e).__name__}: {e})")

    if "powspec" in obs:
        try:
            from montecosmo_tpu.plot import plot_powspec_ppc
            st = model._powspec_static()
            plot_powspec_ppc(st["kmean"], np.asarray(obs["powspec"]),
                             tril=st["tril"], poles=tuple(model.poles))
            plt.savefig(save_dir / f"{prefix}powspec.png", dpi=300)
            plt.close()
        except Exception as e:
            print(f"WARNING: powspec panel skipped ({type(e).__name__}: {e})")

    # the IC-recovery panel needs an observed count MESH; a powspec-observed
    # campaign has no field-level observation to compare against
    if infer_init and "count_mesh" in obs:
        # one jitted program for the FFT/repack chain (see plot_field_warmup)
        def _kptc_obs(cm, wm):
            mesh_obs = jnp.fft.rfftn(model.count2delta(cm))
            mesh_obs = jnp.fft.irfftn(
                chreshape(mesh_obs, r2chshape(model.init_shape)))
            return model.powtranscoh(wm, mesh_obs), model.spectrum(wm)

        kptc_obs, kpow_ref = jax.tree.map(np.asarray, jit(_kptc_obs)(
            jnp.asarray(obs["count_mesh"]), white_mesh))
        kpow_fid = kptc_obs[0], np.ones_like(kptc_obs[0])

        plt.figure(figsize=(12, 4), layout="constrained")
        plt.subplot(131)
        plot_pow(*kpow_ref, "k:", label="true")
        plot_pow(*kpow_fid, "k--", alpha=0.5, label="fiducial")
        plt.subplot(132)
        plt.axhline(1.0, linestyle=":", color="k", alpha=0.5)
        plot_trans(kpow_ref[0], (kpow_fid[1] / kpow_ref[1]) ** 0.5, "k--",
                   alpha=0.5, label="fiducial")
        plt.subplot(133)
        plt.axhline(float(np.mean(np.asarray(model.selec_mesh))), linestyle=":",
                    color="k", alpha=0.5)
        plot_coh(kptc_obs[0], kptc_obs[3], "k--", alpha=0.5, label="obs")

        kptcs = jax.tree.map(jnp.concatenate, chains["kptc_white_mesh"])
        plot_powtranscoh(*kptcs, fill=(0.68, 0.95), color=SetDark2(0))
        plot_powtranscoh(*jax.tree.map(lambda x: jnp.median(x, 0), kptcs),
                         color=SetDark2(0), label="post")
        plt.subplot(131)
        plt.legend()
        plt.savefig(save_dir / f"{prefix}kptc.png", dpi=300)
        plt.close()

    # sample-space chains + traces
    transforms = [partial(Chains.thin, thinning=thinning),
                  partial(Chains.choice, n=10, names=["init", "init_"])]
    chains = model.load_runs(chains_dir, 1, 100, transforms=transforms,
                             batch_ndim=2)
    chains.save(chains_dir / f"{prefix}chains_.h5")
    print(chains.shape, "\n")

    plt.figure(figsize=(12, 12))
    chains.print_summary()
    chains.prune().flatten().plot(list(model.groups_) + ["logdensity"])
    plt.savefig(save_dir / f"{prefix}chains_.png", dpi=300)
    plt.close()
    return chains


def make_logdf_mesh(save_dir, start=1, end=100, thinning=1, prefix="",
                    site="count_mesh"):
    """Per-voxel posterior-predictive (logpdf, logcdf) meshes of `site` over
    the thinned chains — goodness-of-fit maps (mesh context deactivated as
    in make_chains)."""
    from montecosmo_tpu.parallel.context import mesh_context

    with mesh_context(None):
        return _make_logdf_mesh(save_dir, start, end, thinning, prefix, site)


def _make_logdf_mesh(save_dir, start=1, end=100, thinning=1, prefix="",
                     site="count_mesh"):
    from montecosmo_tpu.chains import Chains
    from montecosmo_tpu.models.model import FieldLevelModel
    from montecosmo_tpu.utils.safe import nvmap

    save_dir = Path(save_dir)
    chains_dir = save_dir / "chains"

    model = FieldLevelModel.load(save_dir / "model.yaml")
    obs = h5load(save_dir / "obs.h5")

    model.reset()
    model.substitute(obs, from_base=True)
    model.block()

    chains = model.load_runs(chains_dir, start, end,
                             transforms=[partial(Chains.thin, thinning=thinning)],
                             batch_ndim=2)
    samp_names = set().union(*model.groups_.values())
    params = {k: chains.data[k] for k in samp_names if k in chains.data}
    print(f"logdf_mesh on { {k: jnp.shape(v) for k, v in params.items()} }")

    logpdf_mesh, logcdf_mesh = jit(nvmap(
        lambda p: model.logdf_mesh(p, site=site), 2))(params)
    h5save(chains_dir / f"{prefix}logdf_mesh.h5",
           {"logpdf_mesh": np.asarray(logpdf_mesh),
            "logcdf_mesh": np.asarray(logcdf_mesh)})
    print(f"saved {prefix}logdf_mesh.h5: shape {tuple(logpdf_mesh.shape)}\n")
    return logpdf_mesh, logcdf_mesh


def compare_chains(load_dirs, labels, save_dir="./"):
    """Multi-experiment corner + field-statistics comparison (mesh context
    deactivated as in make_chains)."""
    from montecosmo_tpu.parallel.context import mesh_context

    with mesh_context(None):
        return _compare_chains(load_dirs, labels, save_dir)


def _compare_chains(load_dirs, labels, save_dir="./"):
    import matplotlib.pyplot as plt
    from montecosmo_tpu.chains import Chains
    from montecosmo_tpu.models.model import FieldLevelModel
    from montecosmo_tpu.plot import SetDark2, corner_plot, plot_pow, plot_powtranscoh

    save_dir = Path(save_dir)
    chainss, sels = [], []
    for load_dir, label in zip(load_dirs, labels):
        load_dir = Path(load_dir)
        model = FieldLevelModel.load(load_dir / "model.yaml")
        chains = Chains.load(load_dir / "chains/chains.h5")
        print("\n", chains.shape)
        sels.append(chains.prune()[list(model.groups) + ["~white_mesh"]])
        chainss.append(chains)

    corner_plot(sels, labels=labels)
    plt.savefig(save_dir / f"triangle_{'_'.join(labels)[:200]}.png", dpi=300)
    plt.close()

    mesh_ref = model.white_mesh
    kpow_ref = model.spectrum(mesh_ref)
    plt.figure(figsize=(12, 4), layout="constrained")
    plt.subplot(131)
    plot_pow(*kpow_ref, "k:", label="true")
    for i, (chains, label) in enumerate(zip(chainss, labels)):
        if "kptc_white_mesh" in chains.data:
            kptcs = jax.tree.map(jnp.concatenate, chains["kptc_white_mesh"])
            plot_powtranscoh(*kptcs, fill=0.68, color=SetDark2(i))
            plot_powtranscoh(*jax.tree.map(lambda x: jnp.median(x, 0), kptcs),
                             color=SetDark2(i), label=label)
    plt.subplot(131)
    plt.legend()
    plt.savefig(save_dir / f"kptc_{'_'.join(labels)[:200]}.png", dpi=300)
    plt.close()


def print_mclmc_config(config, state):
    print("\nss: ", np.asarray(config.step_size))
    print("L: ", np.asarray(config.L))
    invmm = np.asarray(config.inverse_mass_matrix)
    print("invmm mean:", invmm.mean(axis=tuple(range(1, invmm.ndim)))
          if invmm.ndim > 1 else invmm.mean())
