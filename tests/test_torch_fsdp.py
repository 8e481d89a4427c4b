"""tpu_rvc_torch's FSDP sharding rule against tpu_rvc's on the CPU: the
axis `fsdp_spec` shards for every leaf shape of the tiny G and D and for
tests/test_train.py's shapes.  (Data-parallel and sharded steps are in
tests/test_torch_dist_train.py.)"""

import pytest
import torch

from tpu_rvc.parallel.fsdp import fsdp_spec as jax_fsdp_spec

from tpu_rvc_torch.core import config
from tpu_rvc_torch.parallel import fsdp
from tpu_rvc_torch.train.step import create_train_state

from test_torch_train import tiny


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_leaf_shapes():
    state = create_train_state(tiny(config), seed=0, device="cpu")
    return sorted({tuple(p.shape) for net in (state.net_g, state.net_d)
                   for p in net.parameters()})


@pytest.mark.parametrize("n_shard", [1, 2, 4])
def test_fsdp_spec_matches_jax(n_shard):
    """tests/test_train.py's shapes and every leaf shape of the tiny G and
    D: the port's axis is the one the JAX PartitionSpec names."""
    shapes = [(7, 64, 128), (128, 64), (64, 128), (33,), (), (256,)]
    for shape in shapes + tiny_leaf_shapes():
        spec = tuple(jax_fsdp_spec(shape, n_shard))
        want = spec.index("model") if "model" in spec else None
        assert fsdp.fsdp_spec(shape, n_shard) == want, shape
