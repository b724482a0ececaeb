"""Checkpoint / resume of a streaming channelizer, in ``fdc_tpu``'s format.

Port of ``fdc_tpu.runtime.checkpoint``. The complete streaming state is

- the device carry (overlap-save history, previous spectrum, burst flags,
  detection slot tables),
- the host emission state (open burst buffers, part counters, message
  IDs; the Python and the native emitters speak one schema),
- the stream cursor (global block index, buffered residual samples).

``save_checkpoint`` writes all three to one pickle; ``load_checkpoint``
restores them into a channelizer built from the same config. The file is
the JAX package's, so a stream saved by either package resumes in the
other:

- ``carry`` holds numpy arrays, complex leaves as float32 [..., 2]
  (re, im) pairs, in the JAX carry's node types (dicts, with their keys in
  the sorted order ``jax.tree.map`` rebuilds them in, and lists);
- ``carry_iscomplex`` is the same tree of Python bools;
- no torch (or JAX) object is pickled, so either side unpickles the
  file without the other's framework.

In memory the port keeps complex64: the pairs exist only in the file.
"""

from __future__ import annotations

import pickle

import numpy as np

from fdc_tpu_torch.convert import carry_from_numpy, carry_to_numpy

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "save_vcm_checkpoint",
    "load_vcm_checkpoint",
]

_FORMAT_VERSION = 1


def _pack(tree):
    """numpy carry -> (packed, iscomplex): complex leaves as float32
    [..., 2] pairs, dict keys sorted as ``jax.tree.map`` orders them."""
    if isinstance(tree, dict):
        items = {k: _pack(tree[k]) for k in sorted(tree)}
        return ({k: p for k, (p, _) in items.items()},
                {k: c for k, (_, c) in items.items()})
    if isinstance(tree, (list, tuple)):
        items = [_pack(v) for v in tree]
        return (type(tree)(p for p, _ in items),
                type(tree)(c for _, c in items))
    if np.iscomplexobj(tree):
        z = np.ascontiguousarray(tree, np.complex64)
        return z.view(np.float32).reshape(*z.shape, 2), True
    return np.asarray(tree), False


def _unpack(packed, iscomplex):
    """The inverse of :func:`_pack`: pairs back to complex64 numpy."""
    if isinstance(packed, dict):
        return {k: _unpack(v, iscomplex[k]) for k, v in packed.items()}
    if isinstance(packed, (list, tuple)):
        return type(packed)(_unpack(v, c) for v, c in zip(packed, iscomplex))
    if iscomplex:
        x = np.ascontiguousarray(packed, np.float32)
        return x.view(np.complex64).reshape(x.shape[:-1])
    return np.asarray(packed)


def _structure(tree):
    """Node types, dict keys and leaf shapes: what ``jax.tree_util``'s
    structure and the leaves' shapes compare in the JAX package."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return tuple(np.shape(tree))


def _restore_carry(ref_carry, state, device):
    """The file's carry on ``device``, validated against ``ref_carry`` (the
    module's own ``_device_init()``)."""
    ref, _ = _pack(carry_to_numpy(ref_carry))
    if _structure(ref) != _structure(state["carry"]):
        raise ValueError(
            "checkpoint carry structure does not match this configuration"
        )
    return carry_from_numpy(
        _unpack(state["carry"], state["carry_iscomplex"]), device)


def save_checkpoint(fdc, path: str):
    """Snapshot the full streaming state of a
    :class:`~fdc_tpu_torch.FrequencyDomainChannelizer` to ``path``."""
    if fdc._carry is None:
        fdc._carry = fdc._device_init()
    # subclass-owned host state first: the hook may sync carry leaves
    host_extra = fdc._host_extra_state()
    packed, iscomplex = _pack(carry_to_numpy(fdc._carry))
    state = {
        "version": _FORMAT_VERSION,
        "carry": packed,
        "carry_iscomplex": iscomplex,
        "t0": int(fdc._t0),
        "pending": fdc._pending.copy(),
        "pending_spec": fdc._pending_spec.copy(),
        "spectra_mode": fdc._spectra_mode,
        "samples_mode": fdc._samples_mode,
        "power_emitter": (
            fdc.power_emitter.get_state() if fdc.power_emitter else None
        ),
        "segment_emitters": [e.get_state() for e in fdc.segment_emitters],
        "host_extra": host_extra,
    }
    with open(path, "wb") as fh:
        pickle.dump(state, fh, protocol=pickle.HIGHEST_PROTOCOL)


def load_checkpoint(fdc, path: str):
    """Restore a snapshot written by ``save_checkpoint`` (of this package
    or of ``fdc_tpu``) into ``fdc``, which must be configured as the
    channelizer that saved it (the carry structure is validated)."""
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    if state.get("version") != _FORMAT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version {state.get('version')}")
    fdc._carry = _restore_carry(fdc._device_init(), state, fdc.device)
    fdc._t0 = int(state["t0"])
    fdc._pending = np.asarray(state["pending"], np.complex64)
    # files older than the vector-mode buffer lack it (absent => empty)
    ps = state.get("pending_spec")
    fdc._pending_spec = (
        np.asarray(ps, np.complex64) if ps is not None
        else np.zeros((0, fdc.config.blocksize), np.complex64)
    )
    fdc._spectra_mode = bool(state.get("spectra_mode", False))
    # files older than the mode guard: samples mode if the stream has
    # processed or buffered samples and is not in vector mode
    fdc._samples_mode = bool(state.get(
        "samples_mode",
        not fdc._spectra_mode and (fdc._t0 > 0 or len(fdc._pending) > 0),
    ))
    if state["power_emitter"] is not None:
        if fdc.power_emitter is None:
            raise ValueError("checkpoint has burst state but config has none")
        fdc.power_emitter.set_state(state["power_emitter"])
    if len(state["segment_emitters"]) != len(fdc.segment_emitters):
        raise ValueError("segment count mismatch")
    for e, st in zip(fdc.segment_emitters, state["segment_emitters"]):
        e.set_state(st)
    fdc._restore_host_extra_state(state.get("host_extra") or {})


def save_vcm_checkpoint(runner, path: str, extra: dict = None):
    """Snapshot an ``ActivityDetectionRunner``'s streaming state (device
    carry, block cursor, open-burst emitter state) plus caller-owned
    numpy ``extra`` leaves (the vcm command's overlap history and sample
    tail). Same packing rules as :func:`save_checkpoint`."""
    if runner._carry is None:
        runner._carry = runner._device_init()
    packed, iscomplex = _pack(carry_to_numpy(runner._carry))
    state = {
        "version": _FORMAT_VERSION,
        "kind": "vcm_runner",
        "carry": packed,
        "carry_iscomplex": iscomplex,
        "t0": int(runner._t0),
        "emitters": [e.get_state() for e in runner.emitters],
        "extra": extra or {},
    }
    with open(path, "wb") as fh:
        pickle.dump(state, fh, protocol=pickle.HIGHEST_PROTOCOL)


def load_vcm_checkpoint(runner, path: str) -> dict:
    """Restore a ``save_vcm_checkpoint`` snapshot (of either package);
    returns its ``extra``."""
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    if (state.get("version") != _FORMAT_VERSION
            or state.get("kind") != "vcm_runner"):
        raise ValueError(
            f"not a vcm runner checkpoint "
            f"(version={state.get('version')}, kind={state.get('kind')})"
        )
    runner._carry = _restore_carry(runner._device_init(), state,
                                   runner.adc.device)
    runner._t0 = int(state["t0"])
    if len(state["emitters"]) != len(runner.emitters):
        raise ValueError("segment count mismatch")
    for e, st in zip(runner.emitters, state["emitters"]):
        e.set_state(st)
    return state["extra"]
