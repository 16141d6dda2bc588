"""L-BFGS with the zoom line search: the torch counterpart of what the JAX
package's `train/optimizers.py::lbfgs_optimizer` builds from optax 0.2.6,

    optax.lbfgs(learning_rate=None, memory_size=15,
                linesearch=optax.scale_by_zoom_linesearch(
                    max_linesearch_steps=25))

that is the chain `scale_by_lbfgs` (optax `_src/transform.py:1573`),
`scale(-1)` and `scale_by_zoom_linesearch` (`_src/linesearch.py:1331`) with
that function's defaults: the initial guess 'keep' (the last accepted
stepsize, 1.0 at first), increase_factor 2, slope_rtol 1e-4, curv_rtol 0.9,
approx_dec_rtol 1e-6, stepsize_precision 1e-5 and no largest stepsize.

  * The optimizer works on one flat vector: the parameter leaves
    concatenated in `weights.tree_leaves` order, which is `param_paths`'
    order (`flatten`, `unflatten`).  A dot product is one `torch.dot` over
    it, where optax adds one `vdot` a leaf in tree order: the same terms,
    associated differently (rounding-level differences).
  * The direction (the ring buffer of the last `memory_size` parameter and
    gradient differences, the two-loop recursion, the first iteration's
    scale min(1, 1/|g|)) stays on the parameters' device and reads nothing
    back.  The buffers are updated in place.
  * The line search's decisions run on the host: it reads the value and the
    slope along the direction once at its start and once a trial
    (`HOST_READS` counts the reads).  Its scalars are numpy scalars of the
    parameters' dtype, as optax's follow the parameters' dtype (float32
    under the JAX package's fp32 config, where x64 is off).
  * `update` takes `value_and_grad_fn(flat) -> (value, flat gradient)` and
    returns the trials it made in the state's `info`, as optax's
    `ZoomLinesearchInfo` does.

`torch.optim.LBFGS` is not used: it has no zoom line search.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: scalar reads to the host made by the line search so far (its start and
#: each trial); a run sets it to 0 and reads it
HOST_READS = 0


def flatten(leaves) -> torch.Tensor:
    """The leaves (tensors) as one flat vector, in their order."""
    return torch.cat([t.detach().reshape(-1) for t in leaves])


def unflatten(flat: torch.Tensor, like):
    """Views of `flat` shaped as the tensors of `like`, in their order."""
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


class ScaleByLBFGSState(NamedTuple):
    """optax's `ScaleByLBFGSState` on flat vectors (count on the host)."""

    count: int
    params: torch.Tensor                # (P,)
    updates: torch.Tensor               # (P,) the last gradient
    diff_params_memory: torch.Tensor    # (memory_size, P)
    diff_updates_memory: torch.Tensor   # (memory_size, P)
    weights_memory: torch.Tensor        # (memory_size,)


class ZoomLinesearchInfo(NamedTuple):
    num_linesearch_steps: int
    decrease_error: np.floating
    curvature_error: np.floating


class ScaleByZoomLinesearchState(NamedTuple):
    learning_rate: np.floating          # the last accepted stepsize
    value: np.floating                  # the value there
    grad: torch.Tensor                  # the gradient there
    info: ZoomLinesearchInfo


class LBFGSState(NamedTuple):
    lbfgs: ScaleByLBFGSState
    linesearch: ScaleByZoomLinesearchState


def _np_dtype(t: torch.Tensor):
    return np.float64 if t.dtype == torch.float64 else np.float32


def _read(*scalars) -> list:
    """Device scalars to numpy scalars of their dtype, in one copy."""
    global HOST_READS
    HOST_READS += 1
    host = torch.stack([s.detach().reshape(()) for s in scalars]).cpu().numpy()
    return list(host)


def _precondition_by_lbfgs(updates, dp_mem, du_mem, rhos, identity_scale,
                           memory_idx: int):
    """optax `_precondition_by_lbfgs`: the two-loop recursion over the ring
    buffer, oldest slot last on the way back and first on the way out."""
    m = rhos.shape[0]
    indices = [(memory_idx + j) % m for j in range(m)]
    vec, alphas = updates, [None] * m
    for j in reversed(range(m)):
        i = indices[j]
        alpha = rhos[i] * torch.dot(dp_mem[i], vec)
        vec = vec + (-alpha) * du_mem[i]
        alphas[j] = alpha
    vec = identity_scale * vec
    for j in range(m):
        i = indices[j]
        beta = rhos[i] * torch.dot(du_mem[i], vec)
        vec = vec + (alphas[j] - beta) * dp_mem[i]
    return vec


def _cubicmin(a, fa, fpa, b, fb, c, fc, dt):
    """optax `_cubicmin`: the critical point of the cubic through (a, fa),
    (b, fb), (c, fc) with slope fpa at a; NaN if there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc * dc * r0 + -(db * db) * r1) / denom
    B = (-(dc * dc * dc) * r0 + db * db * db * r1) / denom
    radical = B * B - dt(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (dt(3.0) * A)


def _quadmin(a, fa, fpa, b, fb, dt):
    """optax `_quadmin`: the critical point of the parabola through (a, fa),
    (b, fb) with slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (dt(2.0) * B)


#: `scale_by_zoom_linesearch`'s defaults (optax `_src/linesearch.py:1331`)
#: with the JAX package's max_linesearch_steps
MAX_LINESEARCH_STEPS = 25
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5


def zoom_linesearch(value_and_grad_fn, params, updates, value, grad,
                    stepsize_guess):
    """optax `zoom_linesearch`'s loop from `init_fn` to the end: the
    interval search (Nocedal and Wright, Algorithm 3.5), then the zoom
    (Algorithm 3.6) by a cubic, a quadratic or bisection, with the
    approximate-decrease test of Hager and Zhang, and the safe stepsize (the
    best point with sufficient decrease) when the search fails.  The
    tolerance on both criteria is 0 and there is no largest stepsize.

    Returns (stepsize, value, grad, info) at the chosen point."""
    dt = _np_dtype(params)
    with np.errstate(all="ignore"):
        return _zoom(value_and_grad_fn, params, updates, value, grad,
                     dt(stepsize_guess), dt)


def _zoom(value_and_grad_fn, params, updates, value, grad, stepsize_guess, dt):
    zero, inf = dt(0.0), dt(np.inf)

    def on_line(stepsize):
        v, g = value_and_grad_fn(params + float(stepsize) * updates)
        v_h, s_h = _read(v, torch.dot(g, updates))
        return v_h, g, s_h

    def decrease_error(stepsize, value_step, slope_step):
        err = value_step - value_init - dt(SLOPE_RTOL) * stepsize * slope_init
        approx = slope_step - dt(2 * SLOPE_RTOL - 1.0) * slope_init
        delta_values = (value_step - value_init
                        - dt(APPROX_DEC_RTOL) * np.abs(value_init))
        err = np.minimum(np.maximum(approx, delta_values), err)
        err = np.maximum(err, zero)
        return inf if np.isnan(err) else err

    def curvature_error(slope_step):
        err = np.abs(slope_step) - dt(CURV_RTOL) * np.abs(slope_init)
        err = np.maximum(err, zero)
        return inf if np.isnan(err) else err

    value_init, slope_init = _read(value, torch.dot(updates, grad))
    s = dict(count=0, stepsize=zero, value=value_init, grad=grad,
             slope=slope_init, decrease_error=inf, curvature_error=inf,
             interval_found=False, done=False, failed=False,
             low=zero, value_low=value_init, slope_low=slope_init,
             high=zero, value_high=value_init, slope_high=slope_init,
             cubic_ref=zero, value_cubic_ref=value_init,
             safe_stepsize=zero, safe_value=value_init, safe_grad=grad)

    def search_interval():
        it = s["count"]
        prev_step, prev_value = s["stepsize"], s["value"]
        prev_slope = s["slope"]
        new_step = (stepsize_guess if it == 0
                    else dt(INCREASE_FACTOR) * prev_step)
        new_value, new_grad, new_slope = on_line(new_step)
        dec = decrease_error(new_step, new_value, new_slope)
        curv = curvature_error(new_slope)
        new_error = np.maximum(dec, curv)
        if dec <= zero:
            s.update(safe_stepsize=new_step, safe_value=new_value,
                     safe_grad=new_grad)
        set_high_to_new = bool(dec > zero) or bool(
            (new_value >= prev_value) and it > 0)
        set_low_to_new = bool(new_slope >= zero) and not set_high_to_new
        if set_low_to_new:
            low = (new_step, new_value, new_slope)
            high = (prev_step, prev_value, prev_slope)
        else:
            low = (prev_step, prev_value, prev_slope)
            high = (new_step, new_value, new_slope)
        done = bool(new_error <= zero)
        interval_found = set_high_to_new or set_low_to_new or done
        s.update(count=it + 1, stepsize=new_step, value=new_value,
                 grad=new_grad, slope=new_slope, decrease_error=dec,
                 curvature_error=curv, interval_found=interval_found,
                 done=done,
                 failed=(it + 1 >= MAX_LINESEARCH_STEPS) and not done,
                 low=low[0], value_low=low[1], slope_low=low[2],
                 high=high[0], value_high=high[1], slope_high=high[2],
                 cubic_ref=low[0], value_cubic_ref=low[1])

    def zoom_into_interval():
        it = s["count"]
        low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
        high, value_high, slope_high = (s["high"], s["value_high"],
                                        s["slope_high"])
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic_chk, quad_chk = dt(0.2) * delta, dt(0.1) * delta
        too_small_int = bool(delta <= dt(STEPSIZE_PRECISION))
        middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                 s["cubic_ref"], s["value_cubic_ref"], dt)
        if left + cubic_chk < middle_cubic < right - cubic_chk:
            middle = middle_cubic
        else:
            middle_quad = _quadmin(low, value_low, slope_low, high,
                                   value_high, dt)
            if left + quad_chk < middle_quad < right - quad_chk:
                middle = middle_quad
            else:
                middle = (low + high) / dt(2.0)
        value_middle, grad_middle, slope_middle = on_line(middle)
        dec = decrease_error(middle, value_middle, slope_middle)
        curv = curvature_error(slope_middle)
        new_error = np.maximum(dec, curv)
        if dec <= zero and value_middle < s["safe_value"]:
            s.update(safe_stepsize=middle, safe_value=value_middle,
                     safe_grad=grad_middle)
        done = bool(new_error <= zero)
        set_high_to_middle = bool(dec > zero) or bool(value_middle >= value_low)
        set_high_to_low = (bool(slope_middle * (high - low) >= zero)
                           and not set_high_to_middle)
        new_high = ((middle, value_middle, slope_middle) if set_high_to_middle
                    else (high, value_high, slope_high))
        if set_high_to_low:
            new_high = (low, value_low, slope_low)
        new_low = ((low, value_low, slope_low) if set_high_to_middle
                   else (middle, value_middle, slope_middle))
        cubic = ((high, value_high) if set_high_to_middle or set_high_to_low
                 else (low, value_low))
        presumably_failed = (it + 1 >= MAX_LINESEARCH_STEPS) or (
            too_small_int and bool(s["safe_stepsize"] > zero))
        s.update(count=it + 1, stepsize=middle, value=value_middle,
                 grad=grad_middle, slope=slope_middle, decrease_error=dec,
                 curvature_error=curv, done=done,
                 failed=presumably_failed and not done,
                 low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
                 high=new_high[0], value_high=new_high[1],
                 slope_high=new_high[2], cubic_ref=cubic[0],
                 value_cubic_ref=cubic[1])

    while not (s["done"] or s["failed"]):
        if s["interval_found"]:
            zoom_into_interval()
        else:
            search_interval()
        if s["failed"] and (bool(s["safe_stepsize"] > zero)
                            or np.isinf(s["decrease_error"])):
            # the safe step: the best point with sufficient decrease, or
            # (outside the domain, with none) no step at all
            s.update(stepsize=s["safe_stepsize"], value=s["safe_value"],
                     grad=s["safe_grad"])
    info = ZoomLinesearchInfo(s["count"], s["decrease_error"],
                              s["curvature_error"])
    return s["stepsize"], s["value"], s["grad"], info


class LBFGS:
    """optax's `lbfgs` chain on flat vectors, with `scale_init_precond` and
    the line search's initial guess 'keep': `init(params)`, then
    `update(updates, state, params, value=, grad=, value_and_grad_fn=)` ->
    (the step to add to params, the new state).  `updates` is the gradient
    to precondition (frozen entries zeroed by the caller); `grad` is the
    gradient the line search's slope uses (the same in the Trainer)."""

    def __init__(self, memory_size: int = 15):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.memory_size = memory_size

    def init(self, params: torch.Tensor) -> LBFGSState:
        zeros = torch.zeros_like(params)
        mem = torch.zeros((self.memory_size,) + tuple(params.shape),
                          dtype=params.dtype, device=params.device)
        dt = _np_dtype(params)
        return LBFGSState(
            ScaleByLBFGSState(0, zeros, zeros, mem, mem.clone(),
                              torch.zeros(self.memory_size, dtype=params.dtype,
                                          device=params.device)),
            ScaleByZoomLinesearchState(
                dt(1.0), dt(np.inf), zeros,
                ZoomLinesearchInfo(0, dt(np.inf), dt(np.inf))))

    def _scale_by_lbfgs(self, updates, state: ScaleByLBFGSState, params):
        m = self.memory_size
        count = state.count
        memory_idx, prev_idx = count % m, (count - 1) % m
        if count > 0:
            diff_params = params - state.params
            diff_updates = updates - state.updates
            vdot = torch.dot(diff_updates, diff_params)
            weight = torch.where(vdot == 0.0, torch.zeros_like(vdot),
                                 1.0 / vdot)
            denominator = torch.dot(diff_updates, diff_updates)
            identity_scale = torch.where(denominator > 0.0,
                                         vdot / denominator,
                                         torch.ones_like(denominator))
        else:
            diff_params = diff_updates = torch.zeros_like(params)
            weight = torch.zeros((), dtype=params.dtype, device=params.device)
            # the first step: a capped reciprocal of the gradient's norm
            identity_scale = torch.clamp(
                1.0 / torch.sqrt(torch.dot(updates, updates)), max=1.0)
        state.diff_params_memory[prev_idx] = diff_params
        state.diff_updates_memory[prev_idx] = diff_updates
        state.weights_memory[prev_idx] = weight
        precond = _precondition_by_lbfgs(
            updates, state.diff_params_memory, state.diff_updates_memory,
            state.weights_memory, identity_scale, memory_idx)
        return precond, state._replace(count=count + 1, params=params,
                                       updates=updates)

    @torch.no_grad()
    def update(self, updates, state: LBFGSState, params, *, value, grad,
               value_and_grad_fn):
        direction, lb = self._scale_by_lbfgs(updates, state.lbfgs, params)
        direction = -direction
        with torch.enable_grad():
            stepsize, value, grad_at, info = zoom_linesearch(
                value_and_grad_fn, params, direction, value, grad,
                state.linesearch.learning_rate)
        return float(stepsize) * direction, LBFGSState(
            lb, ScaleByZoomLinesearchState(stepsize, value, grad_at, info))
