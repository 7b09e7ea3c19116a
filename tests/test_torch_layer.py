"""The port's ``nn.Layer`` (``paddle_tpu_torch/nn/layer/layers.py``)
against the JAX reference's.

- The five model families (tiny GPT, LLaMA, BERT, ResNet-18, PP-YOLOE),
  built in both packages on fresh unique-name counters: ``state_dict()``
  keys equal the reference's, in order, and so do the parameters' unique
  names; the values are facades sharing the tensors' storage.
- ``set_state_dict``: the reference's ``(missing, unexpected)`` and its
  shape-mismatch ValueError, the copy in place.
- A user's subclass of ``nn.Layer`` written the same way in both packages:
  registries, sublayer names, hooks, modes, dtype moves, the containers.
- torch's own forms still work on a Layer: ``Module.state_dict``,
  ``load_state_dict``, ``copy.deepcopy``, ``torch.func.functional_call``.

Values are compared exactly (the same numbers carried across), forward
outputs to rtol 1e-5 / atol 1e-6 (f32).
"""
import copy

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as jpaddle
import paddle_tpu_torch as ppaddle
import torch_ops_audit as A
from paddle_tpu.utils import unique_name as juname
from paddle_tpu_torch.utils import unique_name as puname


@pytest.fixture(autouse=True)
def cpu_place():
    yield from A.cpu_place()


def _families():
    from paddle_tpu.models import bert as jb, gpt as jg, llama as jl
    from paddle_tpu.models import ppyoloe as jy
    from paddle_tpu.vision.models import resnet as jr
    from paddle_tpu_torch.models import bert as pb, gpt as pg, llama as pl
    from paddle_tpu_torch.models import ppyoloe as py
    from paddle_tpu_torch.vision.models import resnet as pr
    f32 = dict(device="cpu", dtype=torch.float32)
    return {
        "gpt": (lambda: jg.GPTForCausalLM(jg.CONFIGS["tiny"]),
                lambda: pg.GPTForCausalLM(pg.CONFIGS["tiny"], device="cpu")),
        "llama": (lambda: jl.LlamaForCausalLM(jl.CONFIGS["tiny"]),
                  lambda: pl.LlamaForCausalLM(pl.CONFIGS["tiny"], **f32)),
        "bert": (lambda: jb.BertForPretraining(jb.CONFIGS["tiny"]),
                 lambda: pb.BertForPretraining(pb.CONFIGS["tiny"], **f32)),
        "resnet18": (lambda: jr.resnet18(),
                     lambda: pr.resnet18(device="cpu")),
        "ppyoloe": (lambda: jy.PPYOLOE(jy.CONFIGS["tiny"]),
                    lambda: py.PPYOLOE(py.CONFIGS["tiny"], device="cpu")),
    }


@pytest.mark.parametrize("family", ["gpt", "llama", "bert", "resnet18",
                                    "ppyoloe"])
def test_state_dict_keys_and_names_equal_the_reference(family, monkeypatch):
    # only names and shapes are compared: the reference's initialisers
    # (a JAX compile for each parameter shape) draw zeros here
    import jax.numpy as jnp
    from paddle_tpu.nn import initializer as jinit
    monkeypatch.setattr(jinit, "_resolve_initializer",
                        lambda init: lambda shape, dtype: jnp.zeros(shape,
                                                                    dtype))
    jbuild, pbuild = _families()[family]
    with juname.guard():
        jmodel = jbuild()
    with puname.guard():
        model = pbuild()
    jsd, sd = jmodel.state_dict(), model.state_dict()
    assert list(sd) == list(jsd)
    assert [tuple(v.shape) for v in sd.values()] == \
        [tuple(v.shape) for v in jsd.values()]
    assert [p.name for p in model.parameters()] == \
        [p.name for p in jmodel.parameters()]
    assert isinstance(model.parameters(), list)
    # facades sharing storage: parameters as Parameters, buffers as Tensors
    params = dict(model.named_parameters())
    for k, v in sd.items():
        assert type(v) is (ppaddle.Parameter if k in params
                           else ppaddle.Tensor), k
    k0 = next(iter(sd))
    assert sd[k0].name == params[k0].name
    with torch.no_grad():
        torch.Tensor.add_(sd[k0], 1.0)
    assert torch.equal(torch.Tensor.detach(sd[k0]), params[k0].detach())


def _bert_pair():
    from paddle_tpu.models import bert as jb
    from paddle_tpu_torch.models import bert as pb
    jmodel = jb.BertForPretraining(jb.CONFIGS["tiny"])
    model = pb.BertForPretraining(pb.CONFIGS["tiny"], device="cpu",
                                  dtype=torch.float32, seed=5)
    return jmodel, model


def test_set_state_dict_matches_the_reference():
    jmodel, model = _bert_pair()
    state = {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}
    dropped = "bert.pooler.dense.bias"
    partial = {k: v for k, v in state.items() if k != dropped}
    partial["no.such.key"] = np.zeros(3, np.float32)
    jmissing, junexpected = jmodel.set_state_dict(
        {k: jpaddle.to_tensor(v) for k, v in partial.items()})
    missing, unexpected = model.set_state_dict(partial)
    assert (missing, unexpected) == (jmissing, junexpected) == \
        ([dropped], ["no.such.key"])
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    for k, v in partial.items():
        if k in got:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # aliases, and the in-place copy (the parameter objects stay)
    assert model.set_dict == model.set_state_dict
    assert model.load_dict == model.set_state_dict
    p = model.bert.pooler.dense.weight
    assert model.set_state_dict(model.state_dict()) == ([], [])
    assert model.bert.pooler.dense.weight is p
    bad = {"bert.pooler.dense.weight": np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError) as jerr:
        jmodel.set_state_dict({k: jpaddle.to_tensor(v)
                               for k, v in bad.items()})
    with pytest.raises(ValueError) as err:
        model.set_state_dict(bad)
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# a user's Layer, the same code in both packages
# ---------------------------------------------------------------------------

def _user_model(paddle, seed_state):
    nn = paddle.nn

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 6)
            self.act = nn.ReLU()
            self.register_buffer("steps", paddle.to_tensor(
                np.zeros([1], np.float32)))
            self.register_buffer("scratch", paddle.to_tensor(
                np.ones([2], np.float32)), persistable=False)

        def forward(self, x):
            return self.act(self.fc(x))

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.blocks = nn.LayerList([Block(), Block()])
            self.head = nn.Sequential(nn.Linear(6, 3), nn.ReLU())
            self.extra = nn.LayerDict({"proj": nn.Linear(6, 6)})
            self.scales = nn.ParameterList()
            self.add_sublayer("tail", nn.Linear(3, 2))

        def forward(self, x):
            h = self.blocks[0](x)
            h = self.extra["proj"](h)
            return self.tail(self.head(h))

    net = Net()
    net.set_state_dict(seed_state) if seed_state else None
    return net


def _net_state():
    rng = np.random.default_rng(11)
    shapes = {"blocks.0.fc.weight": (4, 6), "blocks.0.fc.bias": (6,),
              "blocks.1.fc.weight": (4, 6), "blocks.1.fc.bias": (6,),
              "head.0.weight": (6, 3), "head.0.bias": (3,),
              "extra.proj.weight": (6, 6), "extra.proj.bias": (6,),
              "tail.weight": (3, 2), "tail.bias": (2,),
              "blocks.0.steps": (1,), "blocks.1.steps": (1,)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _run_user_model(paddle, net):
    """Everything a user does with a Layer; returns what to compare."""
    out = {}
    out["keys"] = list(net.state_dict())
    out["sublayers"] = [n for n, _ in net.named_sublayers()]
    out["sublayers_self"] = len(net.sublayers(include_self=True))
    out["params"] = [n for n, _ in net.named_parameters()]
    out["buffers"] = [n for n, _ in net.named_buffers()]
    out["full"] = net.blocks[0].full_name().rsplit("_", 1)[0]
    x = paddle.to_tensor(np.random.default_rng(12).standard_normal(
        (5, 4)).astype(np.float32))
    seen = []
    pre = net.head.register_forward_pre_hook(
        lambda layer, inputs: (inputs[0] * 2,))
    post = net.head.register_forward_post_hook(
        lambda layer, inputs, output: seen.append(1) or output + 1)
    out["hooked"] = net(x).numpy()
    pre.remove()
    post.remove()
    out["unhooked"] = net(x).numpy()
    out["seen"] = len(seen)
    net.eval()
    out["eval"] = [l.training for l in net.sublayers()]
    net.train()
    out["train"] = [l.training for l in net.sublayers()]
    loss = net(x).sum()
    loss.backward()
    out["grad"] = net.tail.weight.grad.numpy()
    net.clear_gradients()
    out["cleared"] = [p.grad is None for p in net.parameters()]
    t = net.create_tensor(dtype="float32")
    out["tensor"] = (list(t.shape), str(t.dtype).split(".")[-1])
    net.to(dtype="float16")
    out["half"] = str(net.tail.weight.dtype).split(".")[-1]
    net.float()
    out["float"] = str(net.tail.weight.dtype).split(".")[-1]
    net.astype("bfloat16")
    out["bf16"] = str(net.tail.weight.dtype).split(".")[-1]
    net.bfloat16().to("cpu")
    out["buffer_dtype"] = str(net.blocks[0].steps.dtype).split(".")[-1]
    out["len"] = (len(net.blocks), len(net.head), len(net.extra),
                  "proj" in net.extra, len(net.scales))
    return out


def test_a_user_layer_behaves_as_the_reference():
    state = _net_state()
    jnet = _user_model(jpaddle, None)
    jnet.set_state_dict({k: jpaddle.to_tensor(v) for k, v in state.items()})
    pnet = _user_model(ppaddle, state)
    want, got = _run_user_model(jpaddle, jnet), _run_user_model(ppaddle,
                                                                  pnet)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            assert got[k] == want[k], k


def test_parameters_and_containers():
    nn = ppaddle.nn
    layer = nn.Layer()
    w = ppaddle.Parameter(np.ones((2, 2), np.float32), name="my_w")
    assert layer.add_parameter("w", w) is w
    assert layer.parameters()[0] is w and layer.state_dict()["w"].name == \
        "my_w"
    layer.v = ppaddle.Parameter(np.zeros(3, np.float32))
    assert [n for n, _ in layer.named_parameters()] == ["w", "v"]
    with pytest.raises(TypeError, match="requires a Parameter"):
        layer.add_parameter("x", torch.ones(2))
    made = layer.create_parameter([2, 2], device="cpu")
    assert made.name == layer.full_name() + ".w_0" and not made.stop_gradient
    plist = nn.ParameterList([w]).append(layer.v)
    assert len(plist) == 2 and plist[1] is layer.v
    seq = nn.Sequential(("a", nn.Linear(2, 2, device="cpu")),
                        ("b", nn.ReLU()))
    assert [n for n, _ in seq.named_children()] == ["a", "b"]
    assert isinstance(seq[0:1], nn.Sequential) and len(seq[0:1]) == 1
    ll = nn.LayerList([nn.ReLU()])
    ll.insert(0, nn.Linear(1, 1, device="cpu")).__class__
    assert isinstance(ll[0], nn.Linear) and len(ll.extend([nn.ReLU()])) == 3
    d = nn.LayerDict({"x": nn.ReLU()})
    assert isinstance(d.pop("x"), nn.ReLU) and len(d) == 0
    # a childless layer stays true in a condition
    assert bool(nn.ReLU())


def test_torch_forms_still_work_on_a_layer():
    _, model = _bert_pair()
    plain = torch.nn.Module.state_dict(model)
    assert list(plain) == list(model.state_dict())
    assert all(type(v) is torch.Tensor for v in plain.values())
    kv = model.state_dict(prefix="m.", keep_vars=True)
    assert next(iter(kv)).startswith("m.") and \
        isinstance(next(iter(kv.values())), torch.nn.Parameter)
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    assert fresh.load_state_dict(plain).missing_keys == []
    assert all(torch.equal(a, b) for a, b in zip(
        fresh.parameters(), model.parameters()))
    # torch's load_state_dict takes Paddle's state_dict() (facades) too
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    assert fresh.load_state_dict({k: v.cpu() for k, v in
                                  model.state_dict().items()}).missing_keys \
        == []
    assert all(torch.equal(a, b) for a, b in zip(
        fresh.parameters(), model.parameters()))
    lin = ppaddle.nn.Linear(3, 2, device="cpu")
    out = torch.func.functional_call(
        lin, {"weight": torch.ones(3, 2), "bias": torch.zeros(2)},
        (torch.ones(1, 3),))
    assert torch.equal(out, torch.full((1, 2), 3.0))
    bn = ppaddle.nn.BatchNorm1D(4, device="cpu")
    bn.register_buffer("tmp", torch.zeros(2), persistent=False)
    assert "tmp" not in bn.state_dict() and "tmp" not in \
        torch.nn.Module.state_dict(bn)
    bn.to(torch.float64)
    assert bn.weight.dtype == bn._mean.dtype == torch.float64
