"""The port's mesh construction (``vnsum_tpu_torch/parallel/mesh.py``)
against the JAX package's ``make_mesh`` and ``mesh_from_spec`` on the 8
CPU devices conftest forces: the shape resolution (defaults of 1, the -1
wildcard, the opt-in fsdp axis, both errors) and the spec parser. A mesh
of one rank needs no process group; the pytest process never joins one.
"""
from __future__ import annotations

import pytest
import torch
import torch.distributed as dist

from vnsum_tpu_torch.parallel import mesh as tm

N_DEVICES = 8

# shapes JAX's make_mesh resolves on 8 devices
SHAPES = {
    "defaults": {},
    "data": {"data": 2},
    "wild_data": {"data": -1},
    "wild_model": {"data": 2, "model": -1},
    "model_seq": {"model": 4, "seq": 2},
    "all": {"data": 2, "model": 2, "seq": 2},
    "fsdp_opt_in": {"data": 2, "fsdp": 2},
    "fsdp_one_dropped": {"data": 2, "fsdp": 1},
    "fsdp_wild": {"fsdp": -1, "model": 2},
    "partial": {"data": 3},
}
# shapes both refuse, with the error's words
ERRORS = {
    "two_wildcards": ({"data": -1, "model": -1}, "at most one mesh axis may be -1"),
    "not_divisible": ({"data": 3, "model": -1}, "not divisible by fixed axes 3"),
    "too_many": ({"data": 4, "model": 4}, "needs 16 devices, have 8"),
}


def jax_shape(shape: dict) -> dict:
    import jax

    from vnsum_tpu.parallel.mesh import make_mesh

    assert len(jax.devices("cpu")) == N_DEVICES
    return dict(make_mesh(shape, platform="cpu").shape)


@pytest.mark.parametrize("name", list(SHAPES))
def test_shape_resolution_matches_jax(name):
    got = tm.resolve_mesh_shape(SHAPES[name], N_DEVICES)
    want = jax_shape(SHAPES[name])
    assert got == want
    assert list(got) == list(want)  # the axes in device order


@pytest.mark.parametrize("name", list(ERRORS))
def test_shape_errors_match_jax(name):
    shape, words = ERRORS[name]
    with pytest.raises(ValueError, match=words):
        tm.resolve_mesh_shape(shape, N_DEVICES)
    with pytest.raises(ValueError, match=words):
        jax_shape(shape)


@pytest.mark.parametrize("spec", ["data=2,model=4", " data = 2 , seq=2,", "", "model=-1"])
def test_spec_parser_matches_jax(spec, monkeypatch):
    from vnsum_tpu.parallel import mesh as jm

    seen = {}
    monkeypatch.setattr(jm, "make_mesh", lambda shape: seen.setdefault("shape", shape))
    jm.mesh_from_spec(spec)
    monkeypatch.undo()
    assert tm.parse_mesh_spec(spec) == seen["shape"]
    assert tm.resolve_mesh_shape(tm.parse_mesh_spec(spec), N_DEVICES) == jax_shape(seen["shape"])


def test_world_one_mesh_needs_no_process_group():
    was = dist.is_initialized()
    m = tm.make_mesh({}, device="cpu")
    assert m.shape == {"data": 1, "model": 1, "seq": 1} and m.size == 1
    assert m.coords == {"data": 0, "model": 0, "seq": 0}
    assert m.groups == {} and m.device_mesh is None
    assert m.group("model").world == 1 and m.group("model").group is None
    assert tm.axis_size(m, "data") == 1 and tm.axis_size(m, "fsdp") == 1
    assert m.captures_collectives()
    assert tm.mesh_from_spec("data=1,model=1", device="cpu").shape == m.shape
    assert dist.is_initialized() == was
    # a world of one rank cannot hold a larger mesh
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tm.make_mesh({"data": 2}, device="cpu")


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        tm.make_mesh({})
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        tm.mesh_from_spec("data=1")
