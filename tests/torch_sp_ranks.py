"""Functions the parallel tests run on every rank of a launched
mesh (``python_audio_mastering_tpu_torch.parallel.mesh.launch``).

Each rank process imports this module to find them, so it imports torch
and the port only, never jax.
"""

import torch

from python_audio_mastering_tpu_torch.ops.iir import sosfilt_sharded
from python_audio_mastering_tpu_torch.parallel import mesh as pmesh


def sharded_filter(sos, x, zi=None, block_size=512):
    """``sosfilt_sharded`` of this rank's equal share of ``x`` ``(N, C)``
    on the 1-D mesh; returns ``(the gathered output (N, C), zf)``."""
    m = pmesh.make_mesh("seq")
    d, i = m.size("seq"), m.index("seq")
    n = x.shape[0] // d
    y, zf = sosfilt_sharded(sos, torch.as_tensor(x[i * n:(i + 1) * n]), m,
                            zi=None if zi is None else torch.as_tensor(zi),
                            block_size=block_size)
    return m.all_gather(y, "seq").reshape(-1, x.shape[1]).numpy(), zf.numpy()


def mesh_probe(tracks):
    """Every collective of a 2-D mesh (``tracks`` rows) on rank-numbered
    tensors: this rank's coordinates and what each collective gave it."""
    m = pmesh.make_mesh_2d(tracks=tracks)
    t = torch.full((2,), float(torch.distributed.get_rank()),
                   dtype=torch.float64)
    out = {"coords": m.coords, "shape": m.shape}
    for axis in m.axis_names:
        out[axis] = {
            "all_gather": m.all_gather(t, axis)[:, 0].tolist(),
            "from_prev": m.from_prev(t, axis)[0].item(),
            "from_next": m.from_next(t, axis)[0].item(),
            "psum": m.psum(t, axis)[0].item(),
            "pmax": m.pmax(t, axis)[0].item(),
        }
    out["world"] = m.all_gather(t)[:, 0].tolist()
    return out


def fail_on(rank):
    """Raise on ``rank`` while the other ranks wait in a collective."""
    m = pmesh.make_mesh("seq")
    if torch.distributed.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return m.all_gather(torch.zeros(1), "seq")


class Interrupt(Exception):
    """Raised from a progress callback to interrupt an album run."""


def album_streamed_resumed(tracks, params, config, checkpoint_dir, stop_after,
                           **kwargs):
    """``master_album_streamed`` on this rank's mesh, interrupted after
    this rank's chunk ``stop_after`` and resumed from ``checkpoint_dir``;
    returns the resumed run's result, the progress messages before the
    interruption and the resumed run's ``on_track_done`` calls
    ``(album index, samples)``."""
    from python_audio_mastering_tpu_torch.parallel import batch

    msgs, done = [], []

    def stop(msg):
        msgs.append(msg)
        if msg.startswith(f"Processed chunk {stop_after}/"):
            raise Interrupt(msg)

    try:
        batch.master_album_streamed(tracks, params, config,
                                    checkpoint_dir=checkpoint_dir,
                                    progress_cb=stop, **kwargs)
    except Interrupt:
        pass
    else:
        raise AssertionError("the run was not interrupted")
    res = batch.master_album_streamed(
        tracks, params, config, checkpoint_dir=checkpoint_dir,
        on_track_done=lambda i, a, m: done.append((i, a.shape[0])), **kwargs)
    return res, msgs, done


def album_streamed_tracks_done(tracks, params, config, **kwargs):
    """``master_album_streamed`` on this rank's mesh; returns its result
    and its ``on_track_done`` calls ``(album index, samples, meters
    given)``, the timings and the progress messages."""
    from python_audio_mastering_tpu_torch.parallel import batch

    done, msgs, timings = [], [], {}
    res = batch.master_album_streamed(
        tracks, params, config, progress_cb=msgs.append, timings=timings,
        on_track_done=lambda i, a, m: done.append(
            (i, a.shape[0], m is not None)), **kwargs)
    return res, done, timings, msgs


def raises(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``'s ``ValueError`` message (None if none)."""
    try:
        fn(*args, **kwargs)
    except ValueError as e:
        return str(e)
    return None


def album_fn(config, batch_, params, lengths):
    """``make_album_fn(config)`` on this rank's mesh, on the CPU."""
    from python_audio_mastering_tpu_torch.parallel import batch

    fn = batch.make_album_fn(config, device="cpu")
    return fn(batch_, params, lengths).numpy()


def train_step(config, tracks, targets, theta0, shared, lr):
    """One automaster step on this rank's mesh (``make_train_step(mesh=)``),
    on the CPU: every rank passes the whole batch; returns ``(loss, this
    rank's θ after the step)``."""
    from python_audio_mastering_tpu_torch.models import automaster as am

    model = am.AutoMasterModel(config=config, device="cpu")
    m = pmesh.make_mesh()
    theta = torch.tensor(theta0)
    if not shared:
        theta = pmesh.tracks_sharding(m).shard(theta).clone()
    theta.requires_grad_(True)
    step = am.make_train_step(model, torch.optim.Adam([theta], lr=lr),
                              shared=shared, mesh=m)
    loss = step(theta, torch.as_tensor(tracks), torch.as_tensor(targets))
    return float(loss), theta.detach().numpy()
