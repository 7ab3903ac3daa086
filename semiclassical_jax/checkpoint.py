# coding: utf-8
"""Mid-batch checkpoint/resume of propagator state.

The reference's only persistence unit is a *completed* repetition merged
into the npz accumulator (reference cli.py:453-476) — a killed job loses at
most one batch. For 100k-trajectory batches propagated for thousands of
steps that batch can be expensive, so this module adds the finer-grained
checkpoint the SURVEY calls for (§5 checkpoint/resume): a snapshot of the
full scan carry — trajectory state, branch-cut sign trackers, current time,
and the partial C(t)/k~ic(t) accumulated so far — taken between scan
segments.

Format: a single `.npz` per checkpoint holding the flattened pytree leaves
plus a JSON treedef descriptor. Self-contained and inspectable; no
dependency on orbax's directory layout (orbax remains usable on top for
multi-host settings).
"""

from __future__ import annotations

import os

import numpy as np
import jax

from semiclassical_jax.linalg import from_device, to_device

__all__ = ["save_propagator_state", "load_propagator_state",
           "peek_checkpoint", "CheckpointedRun"]


def _flatten_with_paths(tree):
    leaves_with_paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in leaves_with_paths:
        key = "/".join(str(p) for p in path)
        # from_device fetches complex leaves as two real planes
        out[key] = from_device(leaf)
    return out


def save_propagator_state(filename, propagator, partial=None):
    """Snapshot a propagator's scan carry to `filename` (.npz).

    Parameters
    ----------
    propagator : HermanKlukPropagator / WaltonManolopoulosPropagator
    partial : optional dict of partial observable arrays accumulated so far,
        e.g. {"cauto": ..., "kic": ..., "steps_done": n}
    """
    payload = {}
    for prefix, tree in (("state", propagator.state),
                         ("trackers", propagator.trackers),
                         ("bc", propagator._bc)):
        for key, arr in _flatten_with_paths(tree).items():
            payload[f"{prefix}{key}"] = arr
    payload["meta/t"] = np.asarray(propagator.t)
    payload["meta/ntraj"] = np.asarray(propagator.ntraj)
    if partial:
        for k, v in partial.items():
            payload[f"partial/{k}"] = np.asarray(v)
    # np.savez appends .npz to names without the extension — keep it explicit
    tmp = filename + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, filename)  # atomic on POSIX


def peek_checkpoint(filename):
    """Read only the `partial` metadata of a checkpoint (no propagator
    needed) — used by the CLI to decide which repetition to resume."""
    data = np.load(filename)
    return {key[len("partial/"):]: data[key] for key in data.files
            if key.startswith("partial/")}


def load_propagator_state(filename, propagator):
    """Restore a snapshot into an initialised propagator (shapes must match
    — call initial_conditions with the same ntraj/model first; the sampled
    values are overwritten by the checkpointed ones).

    Returns the `partial` dict stored at save time (possibly empty).
    """
    data = np.load(filename)

    # With an active trajectory mesh, restored per-trajectory leaves (leading
    # axis == ntraj) go back *sharded* over the `traj` axis and everything
    # else replicated — restoring a 100k-trajectory state onto one chip of a
    # mesh is an OOM/perf landmine at exactly the scale checkpointing exists
    # for. Without a mesh the arrays stay uncommitted (single device).
    mesh = getattr(propagator, "mesh", None)
    ntraj = getattr(propagator, "ntraj", -1)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        def sharding_for(shape):
            if len(shape) and shape[0] == ntraj:
                return NamedSharding(
                    mesh, P("traj", *([None] * (len(shape) - 1))))
            return NamedSharding(mesh, P())
    else:
        def sharding_for(shape):
            return None

    def restore(prefix, tree):
        flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
        new_leaves = []
        for path, leaf in flat:
            key = prefix + "/".join(str(p) for p in path)
            if key not in data:
                raise ValueError(
                    f"checkpoint is missing '{key}': it was written by a "
                    "propagator with a different numerical mode or state "
                    "representation (e.g. a pre-comp32 run resumed with "
                    "the comp32 default, or a dense-monodromy checkpoint "
                    "resumed on the diagonal fast path). Resume with the "
                    "original --precision, or delete the checkpoint to "
                    "restart the repetition.")
            arr = data[key]
            if arr.shape != leaf.shape:
                raise ValueError(
                    f"checkpoint shape mismatch for {key}: {arr.shape} vs "
                    f"{leaf.shape} — the checkpoint was written with a "
                    "different state representation (monodromy layout, "
                    "batch size, or precision mode). Resume with the "
                    "original configuration, or delete the checkpoint to "
                    "restart the repetition.")
            # to_device ships complex leaves as two real arrays and
            # recombines them on device (see linalg.py)
            new_leaves.append(to_device(arr, leaf.dtype,
                                        sharding=sharding_for(arr.shape)))
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree), new_leaves)

    propagator.state = restore("state", propagator.state)
    propagator.trackers = restore("trackers", propagator.trackers)
    propagator._bc = restore("bc", propagator._bc)
    propagator._bc_has_nacq = True
    propagator.t = float(data["meta/t"])
    # exact-integrator constants are derived from the state; the restored
    # state invalidates any cached pack (it is rebuilt at the next scan)
    propagator._integ_invalidate()
    partial = {}
    for key in data.files:
        if key.startswith("partial/"):
            partial[key[len("partial/"):]] = data[key]
    return partial


class CheckpointedRun:
    """Propagate in segments with periodic checkpoints and transparent resume.

    Example
    -------
    >>> run = CheckpointedRun("ckpt.npz", propagator, potential,
    ...                       dt=dt, nt=2000, energy0_es=en0,
    ...                       segment=200)
    >>> cauto, kic, err_c, err_k = run.run()  # resumes from ckpt.npz
    ...                                       # if present

    ``run()`` always returns the 4-tuple; the stderr arrays are ``None``
    when ``error_bars`` is off — or when a resumed checkpoint predates the
    request (see run()).
    """

    def __init__(self, filename, propagator, potential, dt, nt,
                 energy0_es=0.0, segment=500, chunk=100, repetition=0,
                 progress=None, error_bars=False, norm_every=0,
                 norm_callback=None):
        self.filename = filename
        self.propagator = propagator
        self.potential = potential
        self.dt = dt
        self.nt = nt
        self.en0 = energy0_es
        self.segment = segment
        # forwarded to propagate(): bounds the length of single XLA
        # executions within a segment
        self.chunk = chunk
        # repetition tag: a checkpoint written during a *different*
        # repetition of the CLI's batch loop must not be resumed into this
        # one (its state belongs to other initial conditions)
        self.repetition = repetition
        # called after every completed segment with (steps_done, nt,
        # cauto_segment)
        self.progress = progress
        # per-step Monte-Carlo standard errors ride along in the partial
        # arrays (each step's stderr is produced by the segment that
        # computed it — nothing to merge across segments)
        self.error_bars = error_bars
        # norm monitoring (the convergence diagnostic of reference
        # cli.py:418-429) composes with checkpointing: segments are split
        # at multiples of `norm_every` and `norm_callback(step)` is
        # called there (and at step 0 on a fresh run) — the callback
        # computes/logs whatever norm flavour it wants (exact or
        # subsampled) from the propagator it closes over. A resumed run
        # picks the monitoring back up at the next boundary.
        self.norm_every = int(norm_every)
        self.norm_callback = norm_callback

    def run(self):
        nt = self.nt
        cauto = np.zeros(nt, dtype=complex)
        kic = np.zeros(nt, dtype=complex)
        error_bars = self.error_bars
        done = 0
        if os.path.exists(self.filename):
            stored_rep = int(peek_checkpoint(self.filename)
                             .get("repetition", 0))
            if stored_rep == self.repetition:
                partial = load_propagator_state(self.filename,
                                                self.propagator)
                if partial:
                    done = int(partial["steps_done"])
                    cauto[:done] = partial["cauto"][:done]
                    kic[:done] = partial["kic"][:done]
                    if error_bars and "cauto_err" not in partial:
                        # the checkpoint predates the error_bars request —
                        # the first `done` steps have no stderr, and zeros
                        # would be *wrong* values. Per the drop-keys
                        # contract, disable stderr for this repetition
                        # instead of storing fabricated ones.
                        import logging
                        logging.getLogger("semiclassical_jax").warning(
                            "resumed checkpoint '%s' was written without "
                            "error_bars — Monte-Carlo stderr is unavailable "
                            "for this repetition (restart it to get error "
                            "bars)", self.filename)
                        error_bars = False
        err_c = np.zeros(nt) if error_bars else None
        err_k = np.zeros(nt) if error_bars else None
        if error_bars and done:
            err_c[:done] = partial["cauto_err"][:done]
            err_k[:done] = partial["kic_err"][:done]
        while done < nt:
            seg = min(self.segment, nt - done)
            if self.norm_every > 0:
                if done % self.norm_every == 0 and \
                        self.norm_callback is not None:
                    self.norm_callback(done)
                # stop the segment at the next monitoring boundary
                seg = min(seg,
                          self.norm_every - done % self.norm_every)
            out = self.propagator.propagate(
                self.potential, self.dt, seg, energy0_es=self.en0,
                chunk=self.chunk, error_bars=error_bars)
            if error_bars:
                c_seg, k_seg, e_c, e_k = out
                err_c[done:done + seg] = e_c
                err_k[done:done + seg] = e_k
            else:
                c_seg, k_seg = out
            cauto[done:done + seg] = c_seg
            kic[done:done + seg] = k_seg
            done += seg
            partial = {"cauto": cauto, "kic": kic, "steps_done": done,
                       "repetition": self.repetition}
            if error_bars:
                partial["cauto_err"] = err_c
                partial["kic_err"] = err_k
            save_propagator_state(self.filename, self.propagator,
                                  partial=partial)
            if self.progress is not None:
                self.progress(done, nt, c_seg)
        return cauto, kic, err_c, err_k
