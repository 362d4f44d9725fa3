"""Parity of the port's halo primitives (``parallel/halo.py``) with the JAX
package's: the computations of tests/test_halo.py on 4 gloo ranks (one
spawn, ``tests/torch_ranks.py``) against the same computations under
``shard_map`` on 4 devices of the virtual CPU mesh, at atol 1e-6 (the JAX
tests' own tolerance against numpy). Also the exchange's zero fill, its
axis-1 form and its pending form, the reductions, and the world-of-1 fills
that need no communication."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from levelsetfusion_tpu.ops.sobolev import generate_1d_sobolev_kernel
from levelsetfusion_tpu.parallel import halo as jhalo
from levelsetfusion_tpu.parallel.mesh import make_mesh
from levelsetfusion_tpu_torch.parallel import halo
from levelsetfusion_tpu_torch.parallel.mesh import Group, block_rows, gather_field
from tests.torch_ranks import run_ranks

ND = 4


def _jax_sharded(fn, x):
    return np.asarray(shard_map(fn, mesh=make_mesh(ND), in_specs=(P("x"),), out_specs=P("x"),
                                check_vma=False)(jnp.asarray(x)))


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(0)
    return {"ramp": np.arange(16, dtype=np.float32).reshape(16, 1) * np.ones((1, 4), np.float32),
            "rnd": rng.standard_normal((16, 8)).astype(np.float32),
            "kernel": generate_1d_sobolev_kernel(7, 0.1)}


@pytest.fixture(scope="module")
def ranks(fields, tmp_path_factory):
    blocks = run_ranks("tests.torch_ranks.halo_cases", ND, tmp_path_factory.mktemp("halo"),
                       fields)
    return {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}


def _jax_cases(fields):
    """tests/test_halo.py's sharded functions, and the extra cases'."""
    k = jnp.asarray(fields["kernel"])

    def d_edge(blk):
        return jhalo.d0_edge_fixed(jhalo.halo_exchange(blk, 2, "x", ND, fill="replicate"), 2,
                                   "x", ND)

    return {
        "replicate_left": ("ramp", lambda b: jhalo.halo_exchange(b, 2, "x", ND,
                                                                 fill="replicate")[:4]),
        "truncation_right": ("ramp", lambda b: jhalo.halo_exchange(b, 1, "x", ND,
                                                                   fill="truncation")[-2:]),
        "d_edge_fixed": ("rnd", lambda b: d_edge(b)[1:-1]),
        "d_edge_fixed_twice": ("rnd", lambda b: jhalo.d0_edge_fixed(d_edge(b), 1, "x", ND)),
        "second_diff": ("rnd", lambda b: jhalo.second_diff0(
            jhalo.halo_exchange(b, 1, "x", ND, fill="replicate"))),
        "convolve_zero_edges": ("rnd", lambda b: jhalo.convolve0_zero_edges(b, k, "x", ND)),
        "zero_pending": ("rnd", lambda b: jhalo.halo_exchange(b, 3, "x", ND, fill="zero")),
    }


@pytest.mark.parametrize("case", ["replicate_left", "truncation_right", "d_edge_fixed",
                                  "d_edge_fixed_twice", "second_diff", "convolve_zero_edges",
                                  "zero_pending"])
def test_matches_jax_on_4_ranks(case, fields, ranks):
    name, fn = _jax_cases(fields)[case]
    np.testing.assert_allclose(ranks[case], _jax_sharded(fn, fields[name]), atol=1e-6)


def test_axis1_exchange_and_reductions(fields, ranks):
    """The warp's exchange runs along axis 1 of the component-major block;
    the sums and maxes reduce over the ranks."""
    rnd = fields["rnd"]
    want = _jax_sharded(lambda b: jhalo.halo_exchange(b, 2, "x", ND, fill="truncation"), rnd)
    np.testing.assert_array_equal(ranks["axis1"], np.concatenate(
        [want[r * 8:(r + 1) * 8].T for r in range(ND)]))
    np.testing.assert_allclose(ranks["psum"], [rnd.sum()] * ND, rtol=1e-6)
    np.testing.assert_array_equal(ranks["pmax"], [rnd.max()] * ND)


@pytest.mark.parametrize("fill,left,right", [("replicate", 0.0, 15.0), ("zero", 0.0, 0.0),
                                             ("truncation", 1.0, 1.0)])
def test_world_of_1_only_fills(fill, left, right):
    """A world of 1 has no neighbours: both halos are the global fill (the
    JAX twin's mesh-of-1 branch), and the reductions and gather are
    identities."""
    one = Group(0, 1, torch.device("cpu"))
    x = torch.arange(16, dtype=torch.float32).view(16, 1).expand(16, 3).contiguous()
    ext = halo.halo_exchange(x, 2, one, fill=fill)
    want = np.asarray(jhalo.halo_exchange(jnp.asarray(x.numpy()), 2, "x", 1, fill=fill))
    np.testing.assert_array_equal(ext.numpy(), want)
    assert ext[0, 0] == left and ext[-1, 0] == right
    assert halo.psum_axis(x, one) is x and halo.pmax_axis(x, one) is x
    assert gather_field(x, one) is x


def test_block_rows_and_refusals():
    assert [block_rows(16, r, 4) for r in range(4)] == [(0, 4), (4, 8), (8, 12), (12, 16)]
    with pytest.raises(ValueError, match="divide"):
        block_rows(10, 0, 4)
    one = Group(0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="fill"):
        halo.halo_exchange(torch.zeros(4, 2), 1, one, fill="wrap")
    with pytest.raises(ValueError, match="exceeds"):
        halo.halo_exchange(torch.zeros(4, 2), 5, one)
