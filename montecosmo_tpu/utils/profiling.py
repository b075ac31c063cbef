"""Profiling and observability hooks.

The reference has no built-in tracing (SURVEY §5: ad-hoc debug prints and
tqdm only); here profiling is first-class:

* `phase(name)`      — wall-clock phase timer with a process-global report,
* `trace(logdir)`    — jax.profiler trace context (view in TensorBoard /
                       xprof),
* `annotate(name)`   — TraceAnnotation for device-timeline labelling,
* `check_finite`     — jit-friendly NaN/Inf guard with a named error.
"""
import contextlib
import time
from collections import defaultdict

import jax
from jax import numpy as jnp

_PHASE_TOTALS = defaultdict(float)
_PHASE_COUNTS = defaultdict(int)


@contextlib.contextmanager
def phase(name, verbose=True):
    """Wall-clock a named phase (blocks on async dispatch at exit)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        try:
            jax.effects_barrier()
        except Exception:
            pass
        dt = time.perf_counter() - t0
        _PHASE_TOTALS[name] += dt
        _PHASE_COUNTS[name] += 1
        if verbose:
            print(f"[phase] {name}: {dt:.2f}s")


def phase_report():
    """Cumulative per-phase wall-clock table."""
    lines = [f"{'phase':<32} {'calls':>6} {'total [s]':>10} {'mean [s]':>10}"]
    for name in sorted(_PHASE_TOTALS, key=_PHASE_TOTALS.get, reverse=True):
        tot, cnt = _PHASE_TOTALS[name], _PHASE_COUNTS[name]
        lines.append(f"{name:<32} {cnt:>6} {tot:>10.2f} {tot / cnt:>10.2f}")
    out = "\n".join(lines)
    print(out)
    return out


def reset_phases():
    _PHASE_TOTALS.clear()
    _PHASE_COUNTS.clear()


@contextlib.contextmanager
def trace(logdir="results/jax-trace"):
    """jax.profiler device trace (open with TensorBoard's profile plugin)."""
    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name):
    """Label a region on the device timeline (inside a `trace`)."""
    return jax.profiler.TraceAnnotation(name)


def check_finite(tree, name="value", error=True):
    """Host-side finiteness check of a pytree (forces materialization)."""
    import numpy as np

    bad = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf.real) if np.iscomplexobj(leaf) else np.asarray(leaf)
        if not np.all(np.isfinite(arr)):
            bad.append(jax.tree_util.keystr(path))
    if bad and error:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
    return not bad
