"""tpu_rvc_torch's device mesh against tpu_rvc's on the CPU: axis names
and shapes for each factorisation of four devices, the refusals, rows
split over the data axis and gathered back, and the batched paths' noise
rule (one generator a row).  (`batch_convert` and `convert_long` over
the mesh are in tests/test_torch_parallel.py.)"""

import numpy as np
import pytest
import torch

import jax

from tpu_rvc.core.mesh import make_mesh as jax_make_mesh

from tpu_rvc_torch.core.device import draw_normal
from tpu_rvc_torch.core.mesh import (gather_rows, make_mesh, shard_bounds,
                                     split_rows)


@pytest.mark.parametrize("n_data,n_model", [(4, 1), (2, 2), (1, 4)])
def test_make_mesh_shapes(n_data, n_model):
    """The port's mesh has the JAX one's axis names and shape for the
    same factorisation of four devices."""
    mesh = make_mesh(n_data, n_model, devices=["cpu"] * 4)
    jmesh = jax_make_mesh(n_data, n_model, devices=jax.devices()[:4])
    print(f"mesh {mesh.devices} | jax {dict(jmesh.shape)}")
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.shard_devices == [torch.device("cpu")] * n_data


def test_make_mesh_errors_and_rows():
    """n_data x n_model must equal the device count, as in JAX; the
    default mesh needs CUDA; rows split over the data axis and come back
    in order."""
    with pytest.raises(ValueError, match="mesh 3x1 != 4 devices"):
        make_mesh(3, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        jax_make_mesh(3, devices=jax.devices()[:4])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
    mesh = make_mesh(devices=["cpu"] * 3)
    x = np.arange(6 * 5).reshape(6, 5)
    parts = split_rows(x, mesh)
    print("row blocks", [tuple(p.shape) for p in parts])
    assert [tuple(p.shape) for p in parts] == [(2, 5)] * 3
    assert torch.equal(gather_rows(parts), torch.as_tensor(x))
    with pytest.raises(ValueError, match="not divisible by data axis 3"):
        shard_bounds(7, mesh)


def test_draws_one_row_a_generator():
    """A list of generators draws row i as generator i draws a batch of
    one: the batched paths' noise rule."""
    like = torch.zeros(())
    gens = [torch.Generator().manual_seed(s) for s in (3, 4, 5)]
    got = draw_normal((3, 7, 2), gens, like)
    want = torch.cat([draw_normal((1, 7, 2), torch.Generator().manual_seed(s),
                                  like) for s in (3, 4, 5)])
    print("per-row draws equal:", torch.equal(got, want))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="3 generators for 2 rows"):
        draw_normal((2, 7), gens, like)
