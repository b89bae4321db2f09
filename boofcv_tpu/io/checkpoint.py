"""Checkpoint / resume for long-running jobs.

The reference has no checkpointing (batch library; nearest artifacts are
its YAML/PLY/BAL codecs — SURVEY §5).  Here long sequences
and large BA problems are restartable: scene structure, trajectories,
and arbitrary pytrees of arrays round-trip through a single ``.npz``
(orbax-style contents, zero extra dependencies).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import jax.numpy as jnp

from boofcv_tpu.geo.ba import BAProblem


def save_arrays(path: str, **named_arrays) -> None:
    """Save named arrays (host or device) to one compressed npz."""
    np.savez_compressed(path, **{k: np.asarray(v)
                                 for k, v in named_arrays.items()})


def load_arrays(path: str) -> dict:
    z = np.load(path)
    return {k: z[k] for k in z.files}


def save_ba_problem(path: str, prob: BAProblem) -> None:
    np.savez_compressed(
        path, R=np.asarray(prob.R), t=np.asarray(prob.t),
        intr=np.asarray(prob.intr), points=np.asarray(prob.points),
        obs_xy=np.asarray(prob.obs_xy), obs_view=np.asarray(prob.obs_view),
        obs_valid=np.asarray(prob.obs_valid),
        fixed_views=np.asarray(prob.fixed_views),
        model=np.frombuffer(prob.model.encode(), dtype=np.uint8))


def load_ba_problem(path: str) -> BAProblem:
    z = np.load(path)
    return BAProblem(
        jnp.asarray(z["R"]), jnp.asarray(z["t"]), jnp.asarray(z["intr"]),
        jnp.asarray(z["points"]), jnp.asarray(z["obs_xy"]),
        jnp.asarray(z["obs_view"]), jnp.asarray(z["obs_valid"]),
        jnp.asarray(z["fixed_views"]),
        z["model"].tobytes().decode())


def save_trajectory(path: str, poses: List[Tuple[np.ndarray, np.ndarray]],
                    frame_ids=None) -> None:
    """Save a VO trajectory: list of (R [3,3], t/center [3])."""
    Rs = np.stack([np.asarray(R) for R, _ in poses])
    ts = np.stack([np.asarray(t) for _, t in poses])
    if frame_ids is None:
        frame_ids = np.arange(len(poses))
    np.savez_compressed(path, R=Rs, t=ts, frame_ids=np.asarray(frame_ids))


def load_trajectory(path: str):
    z = np.load(path)
    return ([(z["R"][i], z["t"][i]) for i in range(len(z["R"]))],
            z["frame_ids"])
