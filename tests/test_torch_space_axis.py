"""The port's space axis (``mesh.extra_axes = (("space", k),)``) on gloo CPU
ranks: its collectives, the layers and nets of the registry under
``models.blocks.space_partition``, the row-windowed warp, and one
co-teaching step against the JAX package's step on one device.

The ranks run ``aide_tpu_torch.core.rank_checks.unit_checks``, spawned
through ``mesh.launch`` once a layout (so they import neither JAX nor this
file): space 2 and space 4 (the collectives and the layers), data 2 x
space 2 (the layers and the nets over both axes) and net 2 x space 2 (the
step). Each rank uses one torch thread. The inputs are NumPy arrays from a
seed.

- the collectives: ``halo_rows`` (1 and 2 zero rows, 1 edge row),
  ``gather_h`` and ``space_all_reduce``, forward and gradient, equal
  slicing the padded (or whole) images exactly, on 2 and 4 ranks;
- the layers (f64): the 3x3 conv, the dilated conv, the bilinear upsample,
  the pool, BatchNorm over data x space, GroupNorm and the channel gate on
  each rank's rows equal the layer on the whole images: output, input and
  parameter gradients, running statistics (rtol 1e-9);
- the nets (f64; the logits leave the net in f32): every model of the
  registry (the FuseUNet variants, the UNet with and without attention,
  GroupNorm, learned upsampling and remat) at 64 px, base width 2,
  attention dilation 2 (so that the deepest level's 2 rows a rank hold
  its dilated halo), at space 2 and data 2 x space 2: logits (rtol 1e-6),
  image and parameter gradients, running statistics (rtol 1e-7);
- the windowed warp: ``warp_plain``, ``ops.warp`` (shear and gather) and
  ``tta`` with a row window equal that slice of the whole warp bit for
  bit, and the window's tile boxes are the whole warp's;
- one co-teaching step (FuseUNet, base width 4, 32 px, batch 4, 2 views,
  f32) at space 2 and at net 2 x space 2 against the JAX step on one
  device: losses and dice within 1e-5, parameters and BN statistics under
  tests/test_torch_multidevice.py's 2*lr rule; a supervised step (UNet,
  base width 4) at space 2 against one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from aide_tpu.engine import steps as jsteps
from aide_tpu.engine.state import DualTrainState as JDualState
from aide_tpu.models.fuseunet import FuseUNet as JFuseUNet
from aide_tpu.ops import make_optimizer as j_make_optimizer
from aide_tpu.ops import tta as jtta

from aide_tpu_torch.core import mesh
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.core.rank_checks import _layer, unit_checks
from aide_tpu_torch.engine import steps
from aide_tpu_torch.engine.state import TrainState
from aide_tpu_torch.engine.trainer import init_net
from aide_tpu_torch.interop.weights import variables_to_state_dict
from aide_tpu_torch.models import build_model
from aide_tpu_torch.ops import cuda_warp, tta, warp
from aide_tpu_torch.ops.schedules import make_optimizer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# layouts: (mesh.num_devices, mesh.extra_axes)
LAYOUTS = {
    "space 2": (2, (("space", 2),)),
    "space 4": (4, (("space", 4),)),
    "data 2 x space 2": (4, (("space", 2),)),
    "net 2 x space 2": (4, (("net", 2), ("space", 2))),
}
S, V, B, LR = 32, 2, 4, 1e-4
MODEL_PX, MODEL_B = 64, 2
LAYER_KINDS = ("conv", "dilated", "upsample", "pool", "bn", "gn", "ca")
MODELS = {
    "fuseunet": {},
    "fuseunetsa": {},
    "fuseunetsaseparate": {},
    "unet4": {},
    "unetsa": {},
    "unet4 group learned remat": dict(norm="group", learned_bilinear=True, remat=True),
}


def _mesh_cfg(layout, batch=B):
    cfg = TrainConfig()
    cfg.data.batch_size = cfg.data.eval_batch_size = batch
    cfg.mesh.num_devices, cfg.mesh.extra_axes = LAYOUTS[layout]
    return cfg


def _space(layout):
    return dict(LAYOUTS[layout][1])["space"]


# ------------------------------ the inputs ------------------------------


def _model_cfg(name):
    cfg = TrainConfig()
    opts = dict(MODELS[name])
    cfg.model.name = name.split()[0]
    cfg.model.base_width, cfg.model.compute_dtype = 2, "float32"
    cfg.model.attention_dilation = 2
    for k, v in opts.items():
        setattr(cfg.model, k, v)
    return cfg


def _step_cfg():
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(name="fuseunet", base_width=4, compute_dtype="float32")
    jcfg.data.img_size = S
    jcfg.data.batch_size = jcfg.data.eval_batch_size = B
    jcfg.data.num_tta_views = V
    jcfg.data.warp_method = "shear"
    jcfg.optim.lr = LR
    return jcfg, TrainConfig.from_dict(jcfg.to_dict())


def _step_batch(rng, two_modal=True):
    out = {}
    for m in (("1", "2") if two_modal else ("",)):
        out[f"{'modal' if two_modal else 'image'}{m}"] = rng.integers(
            0, 256, size=(B, S, S, 3), dtype=np.uint8)
        out[f"scale{m}"] = rng.uniform(0.01, 0.03, size=(B, 3)).astype(np.float32)
        out[f"fill{m}"] = rng.uniform(-2.5, -0.5, size=(B, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:S, 0:S]
    for t in (("target1", "target2") if two_modal else ("target",)):
        cy, cx, r = rng.uniform(8, 24), rng.uniform(8, 24), rng.uniform(4, 10)
        base = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.int32)
        out[t] = np.stack([np.roll(base, int(rng.integers(-3, 4)), axis=1) for _ in range(B)])
    return out


def _np_tree(t):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), t)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    x = rng.normal(0.3, 1.2, (4, 4, 8, 6))
    prims = {"x": x}
    for k in (2, 4):
        h = 8 // k
        prims[k] = {f"w_{name}": rng.normal(size=(k, 4, 4, h + 2 * r, 6))
                    for name, r in (("halo1", 1), ("halo2", 2), ("edge1", 1))}
        prims[k].update(w_gather=rng.normal(size=x.shape), w_sum=rng.normal(size=(4, 4, 6)))
    layers = {"x": x, "layers": [{"kind": k, "channels": 4} for k in LAYER_KINDS]}
    for kind in LAYER_KINDS:
        layer = _layer({"kind": kind, "channels": 4}).train()
        with torch.no_grad():
            y = layer(torch.from_numpy(x))
        layers[f"g_{kind}"] = rng.normal(size=tuple(y.shape))
    models = {"models": [], "g": rng.normal(size=(MODEL_B, MODEL_PX, MODEL_PX, 2))}
    for m in range(2):
        models[f"image{m}"] = rng.normal(size=(MODEL_B, MODEL_PX, MODEL_PX, 3))
    for i, name in enumerate(MODELS):
        cfg = _model_cfg(name)
        state = {k: v.numpy().copy() for k, v in init_net(cfg.model, 30 + i).state_dict().items()}
        models["models"].append({"cfg": cfg.to_json(), "state": state})

    jcfg, cfg = _step_cfg()
    jmodel = JFuseUNet(num_classes=2, base_width=4, compute_dtype="float32")
    xj = jnp.zeros((1, S, S, 3))
    variables = [jmodel.init(jax.random.key(k), xj, xj, train=False) for k in (0, 1)]
    key = jax.random.key(100)
    degrees, hflip = jtta.sample_view_params(key, V, B, jcfg.data.rotation_degree,
                                             jcfg.data.hflip_prob)
    step = {"cfg": cfg.to_json(), "batch": _step_batch(rng), "rate": 0.5,
            "nets": [variables_to_state_dict(_np_tree(v)) for v in variables],
            "degrees": np.array(degrees), "hflip": np.array(hflip)}
    sup_cfg = TrainConfig.from_dict(cfg.to_dict())
    sup_cfg.model.name = "unet4"
    sup_cfg.data.variant = "comparison"
    supervised = {"cfg": sup_cfg.to_json(), "batch": _step_batch(rng, two_modal=False),
                  "net": {k: v.numpy().copy()
                          for k, v in init_net(sup_cfg.model, 7).state_dict().items()}}
    augment = {"cfg": cfg.to_json(), "batch": step["batch"],
               "degrees": rng.uniform(-60.0, 60.0, B).astype(np.float32),
               "hflip": (rng.random(B) < 0.5).astype(np.float32)}
    return {"primitives": prims, "layers": layers, "models": models, "step": step,
            "supervised": supervised, "augment": augment,
            "jax": (jcfg, jmodel, variables, key), "layout": {"batches": [B, 3]}}


@pytest.fixture(scope="module")
def ranks(inputs):
    """{layout: {rank: unit_checks' results}}."""
    sent = {
        "space 2": ("layout", "primitives", "layers", "models", "step", "supervised",
                    "augment"),
        "space 4": ("layout", "primitives", "layers"),
        "data 2 x space 2": ("layout", "layers", "models", "augment"),
        "net 2 x space 2": ("layout", "step"),
    }
    out = {}
    for layout, keys in sent.items():
        k = _space(layout)
        send = {key: inputs[key] for key in keys}
        if "primitives" in send:
            send["primitives"] = dict(inputs["primitives"][k], x=inputs["primitives"]["x"])
        out[layout] = mesh.launch(unit_checks, _mesh_cfg(layout), "cpu", (send,))
    return out


# ------------------------------ the layout ------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_of_the_ranks(ranks, layout):
    """Rank r = (d*K + k)*S + s: its data shard, net and space shard, and
    its groups' members; a batch the data axis divides is H-sharded, a
    ragged one is not (unless the data axis is 1)."""
    world, axes = LAYOUTS[layout]
    axes = dict(axes)
    k_net, k_space = axes.get("net", 1), axes["space"]
    d_size = world // (k_net * k_space)
    got = ranks[layout]
    assert sorted(got) == list(range(world))
    for r, res in got.items():
        lay = res["layout"]
        d, k, s = r // (k_net * k_space), (r // k_space) % k_net, r % k_space
        assert (lay["data_rank"], lay["net_rank"], lay["space_rank"]) == (d, k, s)
        assert (lay["data_size"], lay["net_size"], lay["space_size"]) == (d_size, k_net, k_space)
        assert lay["space_group"] == [(d * k_net + k) * k_space + t for t in range(k_space)]
        assert lay["data_group"] == [(e * k_net + k) * k_space + s for e in range(d_size)]
        replica = sorted((e * k_net + k) * k_space + t for e in range(d_size)
                         for t in range(k_space))
        assert lay["replica_group"] == (replica if k_net > 1 else list(range(world)))
        if k_net > 1:
            assert lay["pair_group"] == [(d * k_net + j) * k_space + s for j in range(k_net)]
        assert lay["h_sharded"] == [True, d_size == 1]


# ----------------------------- the collectives -----------------------------


@pytest.mark.parametrize("layout", ["space 2", "space 4"])
@pytest.mark.parametrize("name,r,edge", [("halo1", 1, False), ("halo2", 2, False),
                                         ("edge1", 1, True)])
def test_halo_rows_equal_slicing(ranks, inputs, layout, name, r, edge):
    """Each shard's rows with r rows of each neighbour equal rows
    [s*h, s*h + h + 2r) of the images padded by r rows (zeros, or the edge
    row), and the gradient equals the padded images' (exact)."""
    k = _space(layout)
    x = torch.from_numpy(inputs["primitives"]["x"]).requires_grad_()
    h = x.shape[2] // k
    padded = F.pad(x, (0, 0, r, r), mode="replicate" if edge else "constant")
    w = inputs["primitives"][k][f"w_{name}"]
    loss = 0
    for s in range(k):
        want = padded[:, :, s * h:s * h + h + 2 * r]
        y, _ = ranks[layout][s]["primitives"][name]
        np.testing.assert_array_equal(y, want.detach().numpy())
        loss = loss + (want * torch.from_numpy(w[s])).sum()
    loss.backward()
    dx = np.concatenate([ranks[layout][s]["primitives"][name][1] for s in range(k)], axis=2)
    np.testing.assert_allclose(dx, x.grad.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("layout", ["space 2", "space 4"])
def test_gather_h_and_space_all_reduce(ranks, inputs, layout):
    """``gather_h`` gives every rank the whole images and its backward each
    shard the sum over shards of its rows' gradient (k copies of the
    weights here); ``space_all_reduce`` the sum over shards, its gradient
    likewise summed."""
    k = _space(layout)
    p = inputs["primitives"]
    x = p["x"]
    h = x.shape[2] // k
    for s in range(k):
        y, dx = ranks[layout][s]["primitives"]["gather"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_allclose(dx, k * p[k]["w_gather"][:, :, s * h:(s + 1) * h], rtol=1e-12)
        y, dx = ranks[layout][s]["primitives"]["sum"]
        np.testing.assert_allclose(y, x.sum(axis=2), rtol=1e-12)
        np.testing.assert_allclose(dx, np.broadcast_to(k * p[k]["w_sum"][:, :, None], dx.shape),
                                   rtol=1e-12)


@pytest.mark.parametrize("layout", ["space 2", "space 4"])
def test_halo_collectives(ranks, layout):
    """One all-gather a halo forward and one a backward; gather_h's
    all-gather and reduce-scatter; the all-reduce each way."""
    kinds = ranks[layout][0]["primitives_by_kind"]
    assert kinds["halo"][0] == 6 and kinds["gather"][0] == 2 and kinds["space_sum"][0] == 2


# ------------------------------- the layers -------------------------------


def _layer_reference(inputs, kind):
    lay = inputs["layers"]
    layer = _layer({"kind": kind, "channels": 4}).train()
    x = torch.from_numpy(lay["x"]).requires_grad_()
    y = layer(x)
    (y * torch.from_numpy(lay[f"g_{kind}"])).sum().backward()
    return (y.detach().numpy(), x.grad.numpy(), [p.grad.numpy() for p in layer.parameters()],
            {k: v.numpy() for k, v in layer.named_buffers()})


@pytest.mark.parametrize("layout", ["space 2", "space 4", "data 2 x space 2"])
@pytest.mark.parametrize("kind", LAYER_KINDS)
def test_layer_equals_unsharded(ranks, inputs, layout, kind):
    """Each rank's block through the layer under space_partition (and the
    global statistics) equals the layer on the whole batch: output, input
    gradient and running statistics (f64, rtol 1e-9), parameter gradients
    (rtol 1e-6: the gradient all-reduce sums in an f32 buffer)."""
    y, dx, grads, buffers = _layer_reference(inputs, kind)
    world, _ = LAYOUTS[layout]
    k = _space(layout)
    d_size = world // k
    b, h = dx.shape[0] // d_size, dx.shape[2] // k
    for r, res in ranks[layout].items():
        got = res["layers"][kind]
        d, s = r // k, r % k
        np.testing.assert_allclose(got["y"], y, rtol=1e-9, atol=1e-12, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["dx"], dx[d * b:(d + 1) * b, :, s * h:(s + 1) * h],
                                   rtol=1e-9, atol=1e-12, err_msg=f"rank {r}")
        for g, want in zip(got["grads"], grads):
            np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"rank {r}")
        for name, want in buffers.items():
            np.testing.assert_allclose(got["buffers"][name], want, rtol=1e-9, err_msg=name)


# -------------------------------- the nets --------------------------------


@pytest.fixture(scope="module")
def model_references(inputs):
    out = []
    mod = inputs["models"]
    for spec in mod["models"]:
        cfg = TrainConfig.from_json(spec["cfg"])
        net = build_model(cfg.model)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in spec["state"].items()})
        net = net.double().to(memory_format=torch.channels_last).train()
        n_in = 2 if cfg.model.name.startswith("fuseunet") else 1
        images = [torch.from_numpy(mod[f"image{m}"]).requires_grad_() for m in range(n_in)]
        y = net(*images)
        (y.double() * torch.from_numpy(mod["g"])).sum().backward()
        out.append({"y": y.detach().numpy(), "dx": [x.grad.numpy() for x in images],
                    "grads": {k: p.grad.numpy() for k, p in net.named_parameters()},
                    "stats": {k: v.numpy() for k, v in net.named_buffers()}})
    return out


@pytest.mark.parametrize("layout", ["space 2", "data 2 x space 2"])
@pytest.mark.parametrize("model", list(MODELS))
def test_model_equals_unsharded(ranks, model_references, layout, model):
    """The net on each rank's block (its data rows, its H rows) under
    space_partition equals the net on the whole batch: logits (rtol 1e-6:
    they leave the net in f32), image gradients and running statistics
    (f64, rtol 1e-7 and 1e-9 of the tensor's largest), parameter gradients
    (rtol 1e-6 and 1e-6 of the net's largest: the gradient all-reduce sums
    in an f32 buffer, and a conv bias that a BatchNorm removes has only
    rounding for a gradient). The
    deepest level holds 2 rows a rank, the attention gates' dilated halo."""
    i = list(MODELS).index(model)
    want = model_references[i]
    world, _ = LAYOUTS[layout]
    k = _space(layout)
    d_size = world // k
    b, h = MODEL_B // d_size, MODEL_PX // k
    for r, res in ranks[layout].items():
        got = res["models"][i]
        d, s = r // k, r % k
        np.testing.assert_allclose(got["y"], want["y"], rtol=1e-6, atol=1e-6, err_msg=f"rank {r}")
        for g, ref in zip(got["dx"], want["dx"]):
            np.testing.assert_allclose(g, ref[d * b:(d + 1) * b, s * h:(s + 1) * h], rtol=1e-7,
                                       atol=1e-9 * np.abs(ref).max(), err_msg=f"rank {r}")
        largest = max(np.abs(ref).max() for ref in want["grads"].values())
        for name, ref in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name], ref, rtol=1e-6, atol=1e-6 * largest,
                                       err_msg=name)
        for name, ref in want["stats"].items():
            np.testing.assert_allclose(got["stats"][name], ref, rtol=1e-7, atol=1e-12,
                                       err_msg=name)


@pytest.mark.parametrize("layout", ["space 2", "data 2 x space 2"])
def test_model_collectives(ranks, layout):
    """The halo exchanges of the nets' convolutions and upsamples (each a
    forward and a backward all-gather, remat's recompute its own again),
    the BatchNorms' and the GroupNorm and channel gates' sums all ran."""
    kinds = ranks[layout][0]["models_by_kind"]
    assert kinds["halo"][0] > 0 and kinds["bn"][0] > 0 and kinds["space_sum"][0] > 0
    for res in ranks[layout].values():
        assert res["models_by_kind"] == kinds


# ----------------------------- the windowed warp -----------------------------


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows", [(0, 16), (16, 16), (8, 8), (24, 8), (5, 11)])
def test_windowed_warp_plain_is_a_slice(inverse, rows):
    """warp_plain with an output-row window equals that slice of the whole
    warp bit for bit, at angles over ±135 (every rot90 regime) and both
    flips; its tile boxes are the whole warp's boxes of those tiles."""
    rng = np.random.default_rng(rows[0] + 3 * rows[1])
    n, s, c = 8, 32, 3
    images = torch.from_numpy(rng.normal(size=(n, s, s, c)).astype(np.float32))
    degrees = torch.from_numpy(np.linspace(-135, 135, n).astype(np.float32))
    hflip = torch.tensor([0.0, 1.0] * (n // 2))
    table = cuda_warp.coef_table(degrees, hflip, inverse)
    fill = cuda_warp.fill_table(torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)),
                                n, c, "cpu")
    whole = cuda_warp.warp_plain(images, table, fill, inverse)
    got = cuda_warp.warp_plain(images, table, fill, inverse, rows)
    assert torch.equal(got, whole[:, rows[0]:rows[0] + rows[1]])
    if rows[0] % cuda_warp.TILE == 0 and rows[1] % cuda_warp.TILE == 0:
        t0 = rows[0] // cuda_warp.TILE
        boxes = cuda_warp.source_boxes(table, s, inverse, rows=rows)
        want = cuda_warp.source_boxes(table, s, inverse)[:, t0:t0 + boxes.shape[1]]
        assert torch.equal(boxes, want)


@pytest.mark.parametrize("method", ["shear", "gather", "cuda"])
def test_windowed_warp_ops_are_slices(method):
    """``ops.warp.augment`` / ``invert`` and ``tta.make_views`` /
    ``invert_views`` with a window equal that slice of the whole warp (the
    'cuda' method runs the kernel's plain version on the CPU)."""
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.normal(size=(3, 16, 16, 3)).astype(np.float32))
    degrees = torch.tensor([[-50.0, 10.0, 100.0], [70.0, -120.0, 0.5]])
    hflip = torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
    fill = torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32))
    rows = (8, 8)
    views = tta.make_views(images, degrees, hflip, fill, method=method)
    got = tta.make_views(images, degrees, hflip, fill, method=method, rows=rows)
    assert torch.equal(got, views[:, :, 8:16])
    back = tta.invert_views(views, degrees, hflip, method=method)
    got = tta.invert_views(views, degrees, hflip, method=method, rows=rows)
    assert torch.equal(got, back[:, :, 8:16])
    flat = warp.augment(images, degrees[0], hflip[0], fill, method=method)
    assert torch.equal(warp.augment(images, degrees[0], hflip[0], fill, method=method,
                                    rows=(0, 4)), flat[:, :4])


def test_window_bytes_count_the_rows_read():
    """A window's bound counts the source pixels its taps read, no more than
    the whole image."""
    s, c = 64, 2
    table = cuda_warp.coef_table(torch.zeros(2), torch.zeros(2), False)
    got = cuda_warp.window_bytes_moved(table, s, c, False, (16, 16))
    # 0 degrees: each pixel's taps are itself and its +1 neighbours (at
    # weight 0), so the window reads its 16 rows and the one below
    assert got == 2 * (17 + 16) * s * c * 4 + 2 * 4 * 4 + 2 * c * 4
    table = cuda_warp.coef_table(torch.tensor([45.0, -30.0]), torch.ones(2), True)
    half = cuda_warp.window_bytes_moved(table, s, c, True, (32, 32))
    # at 45 degrees the window's corners fall outside the source
    assert 2 * 32 * s * c * 4 < half < cuda_warp.bytes_moved((2, s, s, c))
    with pytest.raises(ValueError, match="outside an image"):
        cuda_warp.warp_plain(torch.zeros(1, 8, 8, 1), table[:1], torch.zeros(1, 1), False, (4, 5))


# -------------------------------- the step --------------------------------


@pytest.fixture(scope="module")
def jax_one_device(inputs):
    jcfg, jmodel, variables, key = inputs["jax"]
    tx = j_make_optimizer(jcfg.optim, steps_per_epoch=10, num_epochs=10)
    jstate = JDualState.create(*variables, tx)
    jstep = jsteps.make_coteach_train_step(jmodel, True, jcfg)
    batch = {k: jnp.asarray(v) for k, v in inputs["step"]["batch"].items()}
    jstate, m = jstep(jstate, batch, key, jnp.asarray(0.5, jnp.float32))
    return {
        "metrics": {k: float(v) for k, v in m.items()},
        "nets": [variables_to_state_dict(_np_tree(jstate.net_variables(n))) for n in (0, 1)],
        "mu": _np_tree(jstate.opt_state[0].mu),
        "stats": [_np_tree(jstate.net_variables(n))["batch_stats"] for n in (0, 1)],
    }


def _feeds_bn(k):
    """A conv bias that a BatchNorm removes: its gradient is zero up to
    rounding."""
    return (k.endswith(".bias") and k != "last_conv1.bias" and ".bn" not in k
            and not k.endswith("bilinear_up.2.bias"))


def _hold_params(got, ref, grad):
    """tests/test_torch_multidevice.py's bar: within 1e-6 + 1e-2*lr, or 2*lr
    where the gradient is under 5% of its tensor's largest (or feeds a
    norm), the latter for at most 5% of a tensor's elements; BN running
    statistics within rtol 1e-4 and 1e-5 of the tensor's largest."""
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if "running" in k:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=max(1e-7, 1e-5 * np.abs(r).max()),
                                       err_msg=k)
            continue
        feeds_bn = _feeds_bn(k)
        strict = 1e-6 + 1e-2 * LR
        noise = np.abs(grad[k]) < 5e-2 * np.abs(grad[k]).max()
        if feeds_bn:
            noise[...] = True
        bad = np.abs(g - r) > np.where(noise, 2 * LR, strict)
        assert not bad.any(), (k, int(bad.sum()), float(np.abs(g - r).max()))
        if not feeds_bn:
            flipped = int((np.abs(g - r) > strict).sum())
            assert flipped <= max(1, 0.05 * g.size), (k, flipped, g.size)


STEP_LAYOUTS = ["space 2", "net 2 x space 2"]


@pytest.mark.parametrize("key", ["loss1", "loss2", "dice1_sum", "dice2_sum", "count"])
@pytest.mark.parametrize("layout", STEP_LAYOUTS)
def test_step_metrics_equal_jax_on_one_device(ranks, jax_one_device, layout, key):
    for r, res in ranks[layout].items():
        np.testing.assert_allclose(res["step"]["metrics"][key], jax_one_device["metrics"][key],
                                   rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")


@pytest.mark.parametrize("layout", STEP_LAYOUTS)
def test_step_params_equal_jax_on_one_device(ranks, jax_one_device, layout):
    """Each rank's nets (the pair, or net k on a net axis) after the step
    are the JAX step's under the 2*lr rule; the ranks of a net end equal."""
    k_net = dict(LAYOUTS[layout][1]).get("net", 1)
    k_space = _space(layout)
    for r, res in ranks[layout].items():
        held = [(r // k_space) % k_net] if k_net > 1 else [0, 1]
        for got, n in zip(res["step"]["nets"], held):
            grad = variables_to_state_dict({
                "params": jax.tree_util.tree_map(lambda x: x[n] / 0.1, jax_one_device["mu"]),
                "batch_stats": jax_one_device["stats"][n],
            })
            _hold_params(got, jax_one_device["nets"][n], grad)
            first = ranks[layout][(r // k_space) * k_space]["step"]["nets"]
            for name, v in first[held.index(n)].items():
                np.testing.assert_array_equal(got[name], v, err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("layout", STEP_LAYOUTS)
def test_step_collectives(ranks, layout):
    """Every rank of a layout runs the same collectives: the warps' source
    fetches (both modalities in one, then the view logits), the halos,
    BatchNorm over the
    replica group, the gathers of the whole images and one gradient
    all-reduce (of the pair, or of net k)."""
    kinds = ranks[layout][0]["step_by_kind"]
    assert kinds["grad"][0] == 1 and kinds["halo"][0] > 0 and kinds["bn"][0] > 0
    # source rows of both modalities, the view logits, the main logits
    # (gather and its reduce-scatter), the pseudo-labels with the targets
    assert kinds["gather"][0] == 5
    for res in ranks[layout].values():
        assert res["step_by_kind"] == kinds


def test_supervised_step_equals_one_process(ranks, inputs):
    """A supervised step of a UNet at space 2 on each rank's rows equals the
    step of one process: metrics (rtol 1e-5), parameters under the 2*lr
    rule, the ranks equal."""
    inp = inputs["supervised"]
    cfg = TrainConfig.from_json(inp["cfg"])
    net = build_model(cfg.model)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in inp["net"].items()})
    net = net.to(memory_format=torch.channels_last)
    state = TrainState(net, make_optimizer(list(net.parameters()), cfg.optim, 10, 10))
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    batch["target"] = batch["target"].long()
    m = steps.make_supervised_train_step(False, cfg)(state, batch)
    grad = {k: state.optimizer.state[p]["mu"].numpy() / 0.1 for k, p in net.named_parameters()}
    got = ranks["space 2"]
    for r, res in got.items():
        for key, v in m.items():
            np.testing.assert_allclose(res["supervised"]["metrics"][key], float(v), rtol=1e-5,
                                       err_msg=key)
        _hold_params(res["supervised"]["net"], {k: v.numpy() for k, v in
                                                net.state_dict().items()}, grad)
        for name, v in got[0]["supervised"]["net"].items():
            np.testing.assert_array_equal(res["supervised"]["net"][name], v)


@pytest.mark.parametrize("layout", ["space 2", "data 2 x space 2"])
def test_augment_batch_rows_equal_one_process(ranks, inputs, layout):
    """``data.augment_main`` on a spatial batch (whole images fetched, the
    rank's output rows warped) equals the rank's rows of the one-process
    augmented batch exactly: images, targets and the untouched leaves."""
    inp = inputs["augment"]
    cfg = TrainConfig.from_json(inp["cfg"])
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    want = steps.make_augment_batch(cfg, True)(batch, torch.from_numpy(inp["degrees"]),
                                               torch.from_numpy(inp["hflip"]))
    world, _ = LAYOUTS[layout]
    k = _space(layout)
    b, h = B // (world // k), S // k
    for r, got in ranks[layout].items():
        d, s = r // k, r % k
        for key, v in want.items():
            ref = v.numpy()[d * b:(d + 1) * b]
            if ref.ndim >= 3:
                ref = ref[:, s * h:(s + 1) * h]
            np.testing.assert_array_equal(got["augment"][key], ref, err_msg=f"rank {r} {key}")
