"""Functions the sequence-parallel tests run on every rank of a launched
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
    m = pmesh.make_mesh()
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
    m = pmesh.make_mesh()
    if torch.distributed.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return m.all_gather(torch.zeros(1), "seq")
