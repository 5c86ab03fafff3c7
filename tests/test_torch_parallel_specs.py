"""Port parity: the mesh, the spec trees and each rank's shards
(revisionllm_tpu_torch/parallel/{mesh,sharding,launch}.py) against
revisionllm_tpu/parallel on the CPU. The spec trees must equal JAX's
(PartitionSpec compared as a tuple); `shard_params`' local shards, put back
together along their sharded dims, must equal every leaf; the mesh's axes
and groups are read in 8 gloo ranks."""

import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.models import lora as jlora
from revisionllm_tpu.models import revisionllm as jrl
from revisionllm_tpu.ops import quant as jquant
from revisionllm_tpu.parallel import launch as jlaunch
from revisionllm_tpu.parallel import sharding as jshard
from revisionllm_tpu_torch.config import AdapterConfig as TAdapter
from revisionllm_tpu_torch.parallel import launch as tlaunch
from revisionllm_tpu_torch.parallel import mesh as tmesh
from revisionllm_tpu_torch.parallel import sharding as tshard

from torch_parallel_cases import fake_rank as FakeRank
from torch_parallel_cases import mesh_facts, run_ranks
from torch_parity import adapter_kw, tiny_cfgs, to_torch

MESHES = [(2, 2, 2), (1, 1, 2), (2, 1, 1), (1, 2, 1), (1, 4, 2), (4, 1, 2)]


@pytest.fixture(scope="module")
def trees():
    """JAX's tiny f32 tree (2 kv heads), its int8 and int4 trees, a LoRA
    and the T2V adapter, as JAX and as the port's CPU tensors."""
    jcfg, _ = tiny_cfgs(num_kv_heads=2)
    from revisionllm_tpu.config import AdapterConfig as JAdapter
    from revisionllm_tpu.config import LoraConfig as JL

    f32 = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    out = {"f32": f32, "int8": jquant.quantize_llama_params(f32),
           "int8_dense_head": jquant.quantize_llama_params(f32, quantize_lm_head=False),
           "int4": jquant.quantize_llama_params_int4(f32)}
    kw = adapter_kw(jcfg.hidden_size)
    vision = jrl.init_vision_params(JAdapter(**kw), jax.random.PRNGKey(1), d_in=16)
    lora = jlora.init_lora(jcfg, JL(r=4, alpha=8), jax.random.PRNGKey(2))
    return {"jax": {**out, "vision": vision, "lora": lora},
            "port": {k: to_torch(v) for k, v in {**out, "vision": vision, "lora": lora}.items()},
            "adapter": TAdapter(**kw)}


def _as_tuples(spec_tree):
    """A JAX spec tree with every PartitionSpec as a tuple."""
    if isinstance(spec_tree, P):
        return tuple(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _as_tuples(v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(_as_tuples(v) for v in spec_tree)
    return spec_tree


@pytest.mark.parametrize("kind", ["f32", "int8", "int8_dense_head", "int4"])
def test_llama_param_specs_equal_jax(trees, kind):
    want = _as_tuples(jshard.llama_param_specs(trees["jax"][kind]))
    assert tshard.llama_param_specs(trees["port"][kind]) == want


def test_lora_and_vision_specs_equal_jax(trees):
    assert tshard.lora_param_specs(trees["port"]["lora"]) == \
        _as_tuples(jshard.lora_param_specs(trees["jax"]["lora"]))
    got = tshard.vision_param_specs(trees["port"]["vision"])
    want = _as_tuples(jshard.vision_param_specs(trees["jax"]["vision"]))
    assert got == want


def _flat_leaves(tree, spec, path=""):
    """[(path, leaf, spec)] with a spec prefix spread over its leaves."""
    if isinstance(spec, tuple):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in _flat_leaves(tree[k], spec, f"{path}/{k}")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree) for x in _flat_leaves(v, spec, f"{path}/{i}")]
        return [(path, tree, spec)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_leaves(tree[k], spec[k], f"{path}/{k}")]
    return [x for i, v in enumerate(tree) for x in _flat_leaves(v, spec[i], f"{path}/{i}")]


def _assemble(blocks, spec, shape):
    """The leaf put back together from {(d, f, t): block}: the blocks
    concatenated over each axis (tensor, then fsdp, then data) along the
    dim the spec gives it; over an axis the spec does not name every
    rank's block is the same, and one is kept."""
    named = {a: d for d, a in enumerate(spec) if a is not None}
    grid = np.empty(shape, dtype=object)
    for coords, block in blocks.items():
        grid[coords] = block
    for axis in ("tensor", "fsdp", "data"):
        out = np.empty(grid.shape[:-1], dtype=object)
        for idx in np.ndindex(out.shape):
            parts = list(grid[idx])
            if axis in named:
                out[idx] = torch.cat(parts, dim=named[axis])
            else:
                assert all(torch.equal(p, parts[0]) for p in parts), axis
                out[idx] = parts[0]
        grid = out
    return grid[()]


@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, s)) for s in MESHES])
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_shard_params_blocks_reassemble_every_leaf(trees, kind, shape):
    """Every rank's local shards of `llama_param_specs`, concatenated along
    the dims their axes split, equal the whole leaf (the embedding and
    lm_head over (fsdp, tensor), q/k/v/gate/up over (fsdp, tensor), o/down
    over (tensor, fsdp), an int8 scale over its output axis)."""
    params = trees["port"][kind]
    specs = tshard.llama_param_specs(params)
    n = int(np.prod(shape))
    local = [tshard.shard_params(FakeRank(shape, r), params, specs) for r in range(n)]
    for path, leaf, spec in _flat_leaves(params, specs):
        blocks = {}
        for r in range(n):
            m = FakeRank(shape, r)
            got = dict((p, t) for p, t, _ in _flat_leaves(local[r], specs))[path]
            blocks[tuple(m.coord(a) for a in ("data", "fsdp", "tensor"))] = got
        assert torch.equal(_assemble(blocks, spec, shape), leaf), path


def test_shard_params_slices_by_the_spec(trees):
    """At (1, 2, 2) rank 3 (fsdp 1, tensor 1): column-parallel q_proj keeps
    input rows [64, 128) and output columns [64, 128) (4 heads of 32: heads 2
    and 3); row-parallel o_proj the transpose; the int8 scale of q_proj its
    tensor slice, of o_proj its fsdp slice; the norms whole."""
    params = trees["port"]["int8"]
    local = tshard.shard_params(FakeRank((1, 2, 2), 3), params, tshard.llama_param_specs(params))
    q, o = params["layers"]["q_proj"], params["layers"]["o_proj"]
    assert torch.equal(local["layers"]["q_proj"]["q8"], q["q8"][:, 64:, 64:])
    assert torch.equal(local["layers"]["q_proj"]["scale"], q["scale"][:, 64:])
    assert torch.equal(local["layers"]["o_proj"]["q8"], o["q8"][:, 64:, 64:])
    assert torch.equal(local["layers"]["o_proj"]["scale"], o["scale"][:, 64:])
    assert local["layers"]["attn_norm"] is not None
    assert torch.equal(local["layers"]["attn_norm"], params["layers"]["attn_norm"])
    assert tshard.shard_params(None, params, {}) is params


def test_int4_shards_whole_groups():
    """Int4 trees shard like the others where a rank's K is whole groups of
    128 (hidden 256, FFN 512 at tp 2: o_proj keeps 128 rows, down_proj 256),
    and raise where it is not (tp 4: o_proj's 64 rows), as down_proj's K
    11008 / 4 = 2752 does at Vicuna-7B."""
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import llama as tllama

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=1,
                      num_heads=2, num_kv_heads=2, head_dim=128, dtype="float32")
    params = tllama.init_params(cfg, device="cpu", quantize="int4")
    specs = tshard.llama_param_specs(params)
    local = tshard.shard_params(FakeRank((1, 1, 2), 1), params, specs)
    down = params["layers"]["down_proj"]
    assert torch.equal(local["layers"]["down_proj"]["q4"], down["q4"][:, 128:])
    assert torch.equal(local["layers"]["down_proj"]["scale4"], down["scale4"][:, 2:])
    gate = params["layers"]["gate_proj"]
    assert torch.equal(local["layers"]["gate_proj"]["q4"], gate["q4"][:, :, 256:])
    with pytest.raises(ValueError, match="whole groups of 128"):
        tshard.shard_params(FakeRank((1, 1, 4), 0), params, specs)


def test_local_config_splits_heads():
    _, tcfg = tiny_cfgs(num_kv_heads=2)
    local = tshard.local_config(tcfg, FakeRank((1, 1, 2), 0))
    assert (local.num_heads, local.num_kv_heads, local.intermediate_size) == (2, 1, 128)
    assert tshard.local_config(tcfg, FakeRank((2, 2, 1), 0)) is tcfg
    with pytest.raises(ValueError, match="divisible"):
        tshard.local_config(tcfg, FakeRank((1, 1, 4), 0))


def test_mesh_larger_than_the_world_raises():
    with pytest.raises(ValueError, match="needs 8 ranks, have 1"):
        tmesh.create_mesh(2, 2, 2)
    one = tmesh.single_device_mesh()
    assert one.size == 1 and one.devices_shape == (1, 1, 1) and one.axis_names == tmesh.AXES


def test_mesh_axes_and_groups_in_eight_ranks():
    """create_mesh(2, 2, 2) over 8 gloo ranks: JAX's axis names and shape,
    rank r at np.unravel_index(r, (2, 2, 2)), groups of 2 on each axis, 4
    on the batch axes; a mesh of 16 ranks and one of 2 raise."""
    facts = run_ranks(mesh_facts, 8)
    for r, f in enumerate(facts):
        assert f["axes"] == ("data", "fsdp", "tensor") and f["shape"] == (2, 2, 2)
        assert tuple(f["device_mesh"]) == (2, 2, 2)
        d, fs, t = np.unravel_index(r, (2, 2, 2))
        assert f["coord"] == {"data": d, "fsdp": fs, "tensor": t, "batch": 2 * d + fs,
                              "world": r}
        assert f["group_size"] == {"data": 2, "fsdp": 2, "tensor": 2, "batch": 4, "world": 8}
        assert f["process"] == (r, 8)
        assert "needs 16 ranks, have 8" in f[(4, 4, 1)]
        assert "uses 2 of the world's 8 ranks" in f[(2, 1, 1)]
    shards = [f["shard"] for f in facts]
    assert sum(shards, []) == list(range(13)) and shards[-1] == [7, 8, 9, 10, 11, 12]


@pytest.mark.parametrize("world,n", list(itertools.product(range(1, 6), range(14))))
def test_host_shard_indices_match_jax(monkeypatch, world, n):
    """Every rank's share of n items equals JAX's (its process index and
    count monkeypatched), and the shares cover the list once."""
    got = []
    for p in range(world):
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(tlaunch, "process_index", lambda p=p: p)
        monkeypatch.setattr(tlaunch, "process_count", lambda: world)
        share = tlaunch.host_shard_indices(n)
        assert share == jlaunch.host_shard_indices(n)
        got.extend(share)
    assert got == list(range(n))


def test_initialize_distributed_is_a_no_op_alone(monkeypatch):
    """A single process that no launcher started joins nothing; a missing
    rank and an infinite timeout are refused."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tlaunch.initialize_distributed() is False
    assert tlaunch.process_count() == 1 and tlaunch.is_main_process()
    with pytest.raises(ValueError, match="rank"):
        tlaunch.initialize_distributed("127.0.0.1:1", num_processes=2)
    with pytest.raises(ValueError, match="finite"):
        tlaunch.initialize_distributed("127.0.0.1:1", 2, 0, timeout_s=float("inf"))
    assert tlaunch.default_backend("cpu") == "gloo" and tlaunch.default_backend("cuda") == "nccl"


def test_dryrun_prints_its_ok_line():
    """python -m revisionllm_tpu_torch.parallel.dryrun 8: one sharded train
    step and the sharded generate's token parity over 8 gloo ranks."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "revisionllm_tpu_torch.parallel.dryrun", "8"],
                         cwd=root, env={**os.environ, "PYTHONPATH": root},
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh 2x2x2, loss ")
    assert line.endswith("sharded-generate token parity (4, 4) exact")
