"""Port parity of the sharding rules, with no ranks: ``models.partitioning``,
``launch.shardings`` and ``launch.mesh`` of ``repro_torch`` against JAX's
``repro.models.partitioning`` and ``repro.launch.shardings``.

Specs are compared entry by entry (``P`` of both packages is a tuple of
its entries) on ``AbstractMesh``es of both packages, the production
meshes (16, 16) and (2, 16, 16) included, over every registry id's
full-size abstract parameters, optimizer states, batches and caches. The
spec each ``act*`` hint constrains to is held against the spec JAX hands
to ``with_sharding_constraint`` (recorded by monkeypatching JAX's
``current_mesh`` and the constraint; nothing in JAX's package changes).
Also: the placements a spec maps to, the mesh refusals, the hints'
identity without a mesh, ``TrainRun(mesh_shape=(1, 1))`` on one in-process
rank bit-equal to the run without a mesh, and the attention of each model
rank's head shard (``models.attention.local_attention``) against one
whole call through the plain versions of K7 and K7b.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JAbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.launch import shardings as jsh
from repro.models import partitioning as jpt
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tsh
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import partitioning as tpt
from repro_torch.models import registry as treg
from repro_torch.optim import adamw as tadamw
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


def meshes(shape, axes):
    return JAbstractMesh(shape, axes), tpt.AbstractMesh(shape, axes)


def flat_j(tree) -> dict:
    """{dotted path: leaf} of a JAX pytree (dict keys and NamedTuple fields)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (jax.sharding.PartitionSpec,
                                               jax.sharding.NamedSharding)))[0]

    def name(k):
        return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))

    return {".".join(name(k) for k in path): v for path, v in leaves}


def flat_t(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of the port's trees (dicts, NamedTuples)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = tree._asdict().items()
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flat_t(v, f"{prefix}{k}."))
    return out


def assert_specs_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), (what, k, got[k], want[k])


# --------------------------------------------------------------------------
# parameter specs and shardings
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def abstract():
    """{arch: (JAX's abstract params, the port's meta params)} at full size."""
    return {a: (jreg.abstract_params(jreg.get_config(a)),
                treg.abstract_params(treg.get_config(a))) for a in treg.ARCH_IDS}


@pytest.mark.parametrize("fsdp", [False, True])
def test_tree_specs_equal_jax(abstract, fsdp):
    """``spec_for`` through ``tree_specs`` (the stacked prefix included) on
    every registry id's full-size parameters."""
    for arch, (pj, pt_) in abstract.items():
        assert_specs_equal(flat_t(tpt.tree_specs(pt_, fsdp=fsdp)),
                           flat_j(jpt.tree_specs(pj, fsdp=fsdp)), arch)


def test_spec_for_rules():
    for path, shape in [("embed_tokens.embed", (512, 64)), ("layers.attn.wo", (64, 64)),
                        ("layers.moe.experts.w_down", (8, 16, 64)), ("final_norm.norm_w", (64,)),
                        ("layers.mixer.conv_w", (4, 96)), ("mystery", (3, 3))]:
        for fsdp in (False, True):
            assert tuple(tpt.spec_for(path, shape, fsdp=fsdp)) == tuple(
                jpt.spec_for(path, shape, fsdp=fsdp)), (path, fsdp)


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_param_and_opt_shardings_equal_jax(abstract, shape, axes):
    """``tree_shardings`` (= ``param_shardings``, non-dividing axes
    replicated) and ``opt_shardings`` on every id, fsdp on and off."""
    mj, mt = meshes(shape, axes)
    for arch, (pj, pt_) in abstract.items():
        for fsdp in (False, True):
            sj = jsh.param_shardings(mj, pj, fsdp=fsdp)
            st = tsh.param_shardings(mt, pt_, fsdp=fsdp)
            assert all(s.mesh is mt for s in flat_t(st).values())
            assert_specs_equal({k: s.spec for k, s in flat_t(st).items()},
                               {k: s.spec for k, s in flat_j(sj).items()}, (arch, fsdp))
            assert_specs_equal({k: s.spec for k, s in flat_t(
                tpt.tree_shardings(pt_, mt, fsdp=fsdp)).items()},
                {k: s.spec for k, s in flat_j(sj).items()}, (arch, fsdp))
        oj = jsh.opt_shardings(mj, jax.eval_shape(jadamw.init, pj), sj)
        ot = tsh.opt_shardings(mt, tadamw.OptState(None, pt_, pt_), st)
        assert tuple(ot.step.spec) == tuple(oj.step.spec) == ()
        for part in ("mu", "nu"):
            assert_specs_equal({k: s.spec for k, s in flat_t(getattr(ot, part)).items()},
                               {k: s.spec for k, s in flat_j(getattr(oj, part)).items()}, part)


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_batch_shardings_equal_jax(shape, axes):
    mj, mt = meshes(shape, axes)
    for b in (1, 2, 6, 32, 512):
        abs_j = {"tokens": jax.ShapeDtypeStruct((b, 128), jnp.int32),
                 "frames": jax.ShapeDtypeStruct((b, 1500, 64), jnp.bfloat16),
                 "scalar": jax.ShapeDtypeStruct((), jnp.float32)}
        abs_t = {k: torch.empty(v.shape, device="meta") for k, v in abs_j.items()}
        sj, st = jsh.batch_shardings(mj, abs_j), tsh.batch_shardings(mt, abs_t)
        assert_specs_equal({k: s.spec for k, s in st.items()},
                           {k: s.spec for k, s in sj.items()}, b)
    assert tsh.dp_axes(mt) == jsh.dp_axes(mj) and tsh.dp_size(mt) == jsh.dp_size(mj)


def _caches(arch: str, mode: str, batch: int, max_len: int):
    cj = dataclasses.replace(jreg.get_config(arch), kv_mode=mode)
    ct = dataclasses.replace(treg.get_config(arch), kv_mode=mode)
    jm, tm = jreg.get_module(cj), treg.get_module(ct)
    return (jax.eval_shape(lambda: jm.init_cache(cj, batch, max_len)),
            tm.init_cache(ct, batch, max_len, device="meta"))


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_cache_shardings_equal_jax(shape, axes):
    """Every family's cache (both dense-family modes) at a batch that
    divides the DP size and one that does not."""
    mj, mt = meshes(shape, axes)
    for arch in treg.ARCH_IDS:
        for mode in (("dense", "anchored") if treg.get_config(arch).family in ("dense", "vlm")
                     else ("dense",)):
            for batch in (1, 32):
                cj, ct = _caches(arch, mode, batch, 4096)
                sj = jsh.cache_shardings(mj, cj, batch=batch, seq_len=4096)
                st = tsh.cache_shardings(mt, ct, batch=batch, seq_len=4096)
                assert_specs_equal({k: s.spec for k, s in flat_t(st).items()},
                                   {k: s.spec for k, s in flat_j(sj).items()},
                                   (arch, mode, batch))


def test_cache_sharding_heuristic():
    """JAX's ``test_dryrun_unit.py::test_cache_sharding_heuristic`` on the port."""
    mesh = tpt.AbstractMesh((1, 1), ("data", "model"))
    cache = {"k": torch.empty((4, 8, 1024, 16, 64), dtype=torch.bfloat16, device="meta"),
             "length": torch.empty((4, 8), dtype=torch.int32, device="meta")}
    out = tsh.cache_shardings(mesh, cache, batch=8, seq_len=1024)
    spec_k = out["k"].spec
    assert spec_k[1] is not None  # batch axis sharded over dp
    # length (layers, B): batch axis may shard over dp, never over model
    lspec = tuple(out["length"].spec)
    assert "model" not in [e for e in lspec if isinstance(e, str)]


# --------------------------------------------------------------------------
# the activation hints
# --------------------------------------------------------------------------
HINTS = [("act", (4, 32, 6, 16), ("batch", None, "model", None)),
         ("act", (4, 32, 64), ("batch", None, None)),
         ("act", (8, 24, 64), ("model", "batch", None)),
         ("act", (8, 24, 64), ("model", None, None)),
         ("act", (4, 32, 256), ("batch", None, "model")),
         ("act_vocab", (4, 32, 512), ()), ("act_vocab", (4, 32, 50280), ()),
         ("act_vocab", (4, 32, 49155), ()),
         ("act_seq", (4, 32, 64), ()), ("act_seq", (4, 30, 64), ()),
         ("act_seq", (4, 48, 64), ())]


@pytest.mark.parametrize("shape,axes", MESHES + [((4,), ("data",))],
                         ids=MESH_IDS + ["data4"])
def test_act_specs_equal_jax(shape, axes, monkeypatch):
    """The spec each hint constrains to (absent axes dropped, as
    ``constrain`` drops them), against the one JAX passes to
    ``with_sharding_constraint``; None where JAX constrains nothing."""
    mj, mt = meshes(shape, axes)
    seen = []
    monkeypatch.setattr(jpt, "current_mesh", lambda: mj)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    for fn, xs, hint_axes in HINTS:
        seen.clear()
        x = jnp.zeros(xs, jnp.bfloat16)
        getattr(jpt, fn)(x, *hint_axes)
        want = tuple(seen[0]) if seen else None
        with tpt.use_mesh(mt):
            spec = {"act": lambda: tpt.act_spec(*hint_axes),
                    "act_vocab": lambda: tpt.act_vocab_spec(xs),
                    "act_seq": lambda: tpt.act_seq_spec(xs)}[fn]()
        got = None if spec is None else tuple(tpt.fix_spec(mt, spec))
        assert got == want, (fn, xs, hint_axes, got, want)


def test_hints_are_the_identity_without_a_mesh():
    x = torch.randn(2, 8, 6, 16)
    assert tpt.current_mesh() is None
    for y in (tpt.act(x, "batch", None, "model", None), tpt.act_vocab(x), tpt.act_seq(x),
              tpt.contract_whole(x), tpt.constrain(x, tpt.P("data"))):
        assert y is x
    assert tpt.on_replicas(lambda a: a, x) is x


def test_a_plain_tensor_under_a_mesh_raises():
    with tpt.use_mesh(tpt.AbstractMesh((2, 2), ("data", "model"))):
        with pytest.raises(TypeError, match="plain Tensor"):
            tpt.act(torch.zeros(4, 8), "batch", None)
        with pytest.raises(TypeError, match="plain Tensor"):
            tpt.contract_whole(torch.zeros(4, 8))
    assert tpt.current_mesh() is None


def test_placements():
    """One axis, several axes in mesh order (pod-major), an absent axis
    dropped; another order, an axis named twice or too many entries raise."""
    m3 = tpt.AbstractMesh((2, 4, 8), ("pod", "data", "model"))
    m2 = tpt.AbstractMesh((4, 8), ("data", "model"))
    assert tpt.placements(m3, tpt.P(None, "model")) == [Replicate(), Replicate(), Shard(1)]
    assert tpt.placements(m3, tpt.P(("pod", "data"), None, "model")) == [Shard(0), Shard(0),
                                                                          Shard(2)]
    assert tpt.placements(m2, tpt.P(("pod", "data"), "model")) == [Shard(0), Shard(1)]
    assert tpt.placements(m2, tpt.P("pod", None)) == [Replicate(), Replicate()]
    assert tpt.placements(m2, tpt.P()) == [Replicate(), Replicate()]
    assert tpt.NamedSharding(m2, tpt.P("data")).placements(2) == [Shard(0), Replicate()]
    with pytest.raises(ValueError, match="order"):
        tpt.placements(m3, tpt.P(("data", "pod")))
    with pytest.raises(ValueError, match="twice"):
        tpt.placements(m2, tpt.P("data", "data"))
    with pytest.raises(ValueError, match="more entries"):
        tpt.placements(m2, tpt.P("data", None, None), ndim=2)
    assert tpt.P(("data",), None) == ("data", None) == tuple(jax.sharding.PartitionSpec(
        ("data",), None))


# --------------------------------------------------------------------------
# meshes: refusals, the one-rank group, TrainRun on (1, 1)
# --------------------------------------------------------------------------
def test_mesh_refusals():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs an initialized process group"):
        tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(RuntimeError, match="needs an initialized process group"):
        ttrain.TrainRun(arch="llama3.2-3b", mesh_shape=(2, 1), device="cpu").build()
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.make_mesh((1, 1), ("data",), "cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="process group has 1 ranks"):
            tmesh.make_mesh((2, 1), ("data", "model"), "cpu")
        with pytest.raises(ValueError, match="process group has 1 ranks"):
            ttrain.TrainRun(arch="llama3.2-3b", mesh_shape=(1, 2), device="cpu").build()
        m = tmesh.make_mesh((1, 1), ("data", "model"), "cpu")
        assert tmesh.host_device_counts() == {"n_devices": 1, "n_local": 1, "process_index": 0,
                                              "process_count": 1}
        assert m.mesh_dim_names == ("data", "model")
        tmesh.release()  # the caller's group stays
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_one_device_mesh_makes_and_releases_its_group():
    assert not dist.is_initialized()
    m = tmesh.make_mesh((1, 1), ("data", "model"), "cpu")
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert tuple(m.shape) == (1, 1) and m.device_type == "cpu"
    tmesh.release()
    assert not dist.is_initialized()
    assert tmesh.host_device_counts()["n_devices"] == 1


@pytest.mark.parametrize("arch,remat", [(a, "none") for a in treg.ARCH_IDS]
                         + [("llama3.2-3b", "full"), ("zamba2-1.2b", "full"),
                            ("whisper-large-v3", "full")])
def test_train_run_on_a_1x1_mesh_is_bit_equal(arch, remat, monkeypatch):
    """``TrainRun(mesh_shape=(1, 1))`` on one in-process rank, every id (and
    remat on where the config's layer bodies run under a checkpoint, as
    on the card): DTensor parameters, moments and batch, the hints, the
    local-shard attention, bit-equal to the run without a mesh (losses,
    parameters, moments); the group it made is gone after."""
    get = treg.get_config
    monkeypatch.setattr(treg, "get_config", lambda a, smoke=False: dataclasses.replace(
        get(a, smoke=smoke), remat=remat))
    kw = dict(arch=arch, smoke=True, steps=2, batch=2, seq=32, lr=1e-3, log_every=100,
              device="cpu")
    plain = ttrain.TrainRun(**kw).run()
    mesh = ttrain.TrainRun(mesh_shape=(1, 1), **kw).run()
    assert not dist.is_initialized()
    assert mesh["losses"] == plain["losses"]
    for part in ("params", "mu", "nu"):
        a = flat_t(plain["params"] if part == "params" else getattr(plain["opt_state"], part))
        b = flat_t(mesh["params"] if part == "params" else getattr(mesh["opt_state"], part))
        assert set(a) == set(b)
        for k in a:
            assert b[k].placements == (Replicate(), Replicate()), k
            assert torch.equal(a[k].detach(), b[k].detach().to_local()), (part, k)
    assert int(mesh["opt_state"].step) == 2


# --------------------------------------------------------------------------
# K7 and K7b on each model rank's head shard (plain versions on the CPU)
# --------------------------------------------------------------------------
def _inputs(seed=0, b=1, h=24, hkv=8, l=48, dh=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, n, l, dh), generator=g).to(dtype) for n in (h, hkv, hkv))
    return q, k, v, torch.randn((b, h, l, dh), generator=g)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 8, 16, 32])
def test_local_attention_shards_match_the_whole_call(degree):
    """H 24, Hkv 8 (rep 3; llama3.2-3b's groups) over model degrees whose
    shards keep whole kv groups (1, 2, 4, 8), cut them (3, 5, 16, 32: a
    call per ``head_pieces`` piece) or leave ranks empty (16, 32): outputs
    and dQ bit-equal to one whole call; dK and dV bit-equal for whole
    groups, else within ``check_head_shards``' bound (K7b's rounding bound
    and one rounding of each rank's part)."""
    r = tattn.check_head_shards(*_inputs(), degree, causal=True)
    assert r["whole_groups"] == (degree in (1, 2, 4, 8))
    ranges = [tattn.head_range(24, degree, r) for r in range(degree)]
    assert r["calls"] == sum(len(tattn.head_pieces(a, b, 3)) for a, b in ranges)
    assert r["calls"] >= sum(b > a for a, b in ranges)
    assert r["ok"] and r["out_equal"] and r["dq_equal"], r
    assert r["dkv_equal"] or not r["whole_groups"], r


def planted_local_attention(q, k, v, h0, h1, n_heads, *, causal):
    """The helper with its kv heads one group off (the kv axis rolled)."""
    return tattn.local_attention(q, k.roll(-1, 1), v.roll(-1, 1), h0, h1, n_heads,
                                 causal=causal)


def test_head_pieces():
    assert tattn.head_pieces(0, 12, 3) == [(0, 12)]
    assert tattn.head_pieces(0, 8, 3) == [(0, 6), (6, 8)]
    assert tattn.head_pieces(8, 16, 3) == [(8, 9), (9, 15), (15, 16)]
    assert tattn.head_pieces(4, 5, 3) == [(4, 5)]
    assert tattn.head_pieces(2, 4, 3) == [(2, 3), (3, 4)]
    assert tattn.head_pieces(5, 5, 3) == []


def test_a_kv_offset_one_group_off_fails():
    r = tattn.check_head_shards(*_inputs(1), 4, causal=True, local=planted_local_attention)
    assert not r["ok"] and not r["out_equal"], r
