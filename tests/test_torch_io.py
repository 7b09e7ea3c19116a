"""``paddle.save`` / ``paddle.load`` (``paddle_tpu_torch/framework/
io_api.py``) against the JAX reference, both ways, and a user's whole
training script run under both packages.

- The port reads and writes the reference's file format: f32, f16, f64,
  the integers, bool and bf16 (the reference's ``ml_dtypes`` arrays, read
  here without ``ml_dtypes``) come back bit for bit, reference → port and
  port → port, inside nested dicts, lists and tuples; the reference reads
  the port's files (f32, integers and bf16) bit for bit; ``return_numpy``.
- The reference's checks and messages: the protocol range, unknown config
  keys. The atomic writer leaves no file behind a failed write; the
  reader refuses every global the payload files do not name (crafted
  pickles that call ``numpy.load`` or walk ``getattr`` chains); protocols
  2 and 3 round-trip both ways.
- One user script (train two steps with ``paddle.grad`` beside
  ``backward``, evaluate under ``paddle.no_grad()``, save the model's and
  Momentum's state dicts, restore them into a fresh model and optimizer,
  resume one step) on a 2-layer BERT, its text the same for both
  packages but for the import: the losses agree to rtol 1e-5 (f32 on two
  libraries), the resumed step equals the uninterrupted one bit for bit
  within each package, and the port resumes from the reference's files
  to the reference's loss (rtol 1e-5).
"""
import os
import pickle

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as jpaddle
import paddle_tpu_torch as ppaddle
import torch_ops_audit as A
from paddle_tpu_torch.utils import resilience


@pytest.fixture(autouse=True)
def cpu_place():
    yield from A.cpu_place()


RNG = np.random.default_rng(0)
ARRAYS = {
    "f32": RNG.standard_normal((3, 4)).astype(np.float32),
    "f16": RNG.standard_normal(5).astype(np.float16),
    "f64": RNG.standard_normal(4),
    "i8": np.array([-3, 0, 7], np.int8),
    "i32": RNG.integers(-2**31, 2**31 - 1, 6, dtype=np.int32),
    "i64": np.array([-2**40, 5], np.int64),
    "u8": np.array([0, 255], np.uint8),
    "bool": np.array([True, False, True]),
}
BF16_BITS = np.array([0x3FC0, 0xC010, 0x7F80, 0x0001, 0x8000], np.uint16)


def _bits(t):
    t = torch.Tensor.as_subclass(t, torch.Tensor).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _nested(make, wide="i64"):
    return {"w": make("f32"), "group": {"b": make("i32"), "list": [
        make(wide), 3, "text", (make("bool"), 2.5)]}, "step": 7}


def test_port_round_trip_is_bitwise_in_every_dtype(tmp_path):
    obj = {k: torch.from_numpy(a) for k, a in ARRAYS.items()}
    obj["bf16"] = torch.from_numpy(BF16_BITS.view(np.int16)).view(
        torch.bfloat16)
    obj["nested"] = _nested(lambda k: torch.from_numpy(ARRAYS[k]))
    obj["param"] = ppaddle.Parameter(np.ones(2, np.float32), name="fc_0.w_0")
    ppaddle.save(obj, str(tmp_path / "a.pdparams"))
    back = ppaddle.load(str(tmp_path / "a.pdparams"))
    for k in ARRAYS:
        assert back[k].dtype == obj[k].dtype
        np.testing.assert_array_equal(_bits(back[k]), ARRAYS[k])
    np.testing.assert_array_equal(_bits(back["bf16"]), BF16_BITS)
    assert type(back["bf16"]) is ppaddle.Tensor and back["bf16"].stop_gradient
    n = back["nested"]
    np.testing.assert_array_equal(_bits(n["group"]["list"][3][0]),
                                  ARRAYS["bool"])
    assert n["step"] == 7 and n["group"]["list"][1:3] == [3, "text"]
    assert isinstance(n["group"]["list"][3], tuple)
    assert type(back["param"]) is ppaddle.Parameter
    assert back["param"].name == "fc_0.w_0" and not back["param"].stop_gradient
    assert back["f32"].place == ppaddle.CPUPlace()


def test_reference_files_load_bitwise(tmp_path):
    path = str(tmp_path / "ref.pdparams")
    obj = {k: jpaddle.to_tensor(a) for k, a in ARRAYS.items()
           if k not in ("f64", "i64")}    # the reference holds 32 bits
    bf = jpaddle.to_tensor(np.array([1.5, -2.25, 3e38, 1e-40, -0.0],
                                    np.float32)).astype("bfloat16")
    obj["bf16"] = bf
    obj["nested"] = _nested(lambda k: jpaddle.to_tensor(ARRAYS[k]), "u8")
    obj["param"] = jpaddle.Parameter(np.ones(3, np.float32), name="p_0")
    jpaddle.save(obj, path)
    back = ppaddle.load(path)
    for k in obj:
        if k in ARRAYS:
            np.testing.assert_array_equal(_bits(back[k]), ARRAYS[k])
    want = np.asarray(bf._value).view(np.uint16)
    assert back["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(back["bf16"]), want)
    assert type(back["param"]) is ppaddle.Parameter and \
        back["param"].name == "p_0"
    np.testing.assert_array_equal(_bits(back["nested"]["group"]["b"]),
                                  ARRAYS["i32"])
    arrays = ppaddle.load(path, return_numpy=True)
    jarrays = jpaddle.load(path, return_numpy=True)
    np.testing.assert_array_equal(arrays["f32"], jarrays["f32"])
    # bf16 comes out as float32 (numpy has no bf16 without ml_dtypes)
    np.testing.assert_array_equal(
        arrays["bf16"], np.asarray(jarrays["bf16"], np.float32))


def test_the_reference_reads_the_port_files(tmp_path):
    path = str(tmp_path / "port.pdparams")
    obj = {k: torch.from_numpy(ARRAYS[k]) for k in ("f32", "i8", "i32",
                                                    "u8", "bool")}
    obj["bf16"] = torch.from_numpy(BF16_BITS.view(np.int16)).view(
        torch.bfloat16)
    obj["nested"] = _nested(lambda k: torch.from_numpy(ARRAYS[k]))
    obj["param"] = ppaddle.Parameter(np.ones(2, np.float32), name="q_0")
    ppaddle.save(obj, path)
    back = jpaddle.load(path)
    for k in ("f32", "i8", "i32", "u8", "bool"):
        np.testing.assert_array_equal(np.asarray(back[k].numpy()), ARRAYS[k])
    np.testing.assert_array_equal(
        np.asarray(back["bf16"]._value).view(np.uint16), BF16_BITS)
    assert back["param"].name == "q_0" and back["param"].trainable
    np.testing.assert_array_equal(
        np.asarray(back["nested"]["group"]["b"].numpy()), ARRAYS["i32"])
    assert back["nested"]["group"]["list"][1:3] == [3, "text"]


def test_checks_and_messages_match_the_reference(tmp_path):
    path = str(tmp_path / "x.pdparams")
    for kw in (dict(protocol=5), dict(protocol=1), dict(protocol="4"),
               dict(use_binary_format=True)):
        with pytest.raises(ValueError) as jerr:
            jpaddle.save({"a": 1}, path, **kw)
        with pytest.raises(ValueError) as err:
            ppaddle.save({"a": 1}, path, **kw)
        assert str(err.value) == str(jerr.value)
    ppaddle.save({"a": 1}, path, protocol=2)
    with pytest.raises(ValueError) as jerr:
        jpaddle.load(path, keep_name_table=True)
    with pytest.raises(ValueError) as err:
        ppaddle.load(path, keep_name_table=True)
    assert str(err.value) == str(jerr.value)
    assert ppaddle.load(path) == jpaddle.load(path) == {"a": 1}


def test_atomic_write_and_a_refused_class(tmp_path):
    path = str(tmp_path / "sub" / "y.pdparams")
    ppaddle.save({"a": torch.ones(2)}, path)

    def broken(f):
        f.write(b"partial")
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        resilience.atomic_write(path, broken)
    assert os.listdir(tmp_path / "sub") == ["y.pdparams"]
    assert float(ppaddle.load(path)["a"].sum()) == 2.0
    with open(path, "wb") as f:
        pickle.dump({"x": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        ppaddle.load(path)


class _Call:
    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("crafted", [
    lambda path: _Call(np.load, path, None, True),
    lambda path: _Call(getattr, object, "__subclasses__"),
    lambda path: _Call(getattr, _Call(__import__("importlib").import_module,
                                      "ml_dtypes"), "__class__"),
    lambda path: _Call(__import__("importlib").import_module, "os"),
    lambda path: _Call(np.frombuffer, b"\0" * 4),
], ids=["numpy.load", "object.__subclasses__", "namespace.__class__",
        "import_module(os)", "numpy.frombuffer"])
@pytest.mark.parametrize("protocol", [2, 4])
def test_crafted_pickles_are_refused(tmp_path, crafted, protocol):
    """Only the globals the payload files name resolve, and ``getattr``
    reaches only ``object.__new__`` and the names of the namespaces the
    loader hands back."""
    path = str(tmp_path / "evil.pdparams")
    with open(path, "wb") as f:
        pickle.dump({"x": crafted(path)}, f, protocol=protocol)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        ppaddle.load(path)


@pytest.mark.parametrize("protocol", [2, 3])
def test_older_protocols_round_trip_both_ways(tmp_path, protocol):
    """Protocol 2 writes Python 2's module names and its bytes through
    ``_codecs.encode``; both packages read each other's files at it."""
    bf16 = torch.from_numpy(BF16_BITS.view(np.int16)).view(torch.bfloat16)
    ppaddle.save({"f32": torch.from_numpy(ARRAYS["f32"]), "bf16": bf16,
                  "i32": torch.from_numpy(ARRAYS["i32"])},
                 str(tmp_path / "p.pdparams"), protocol=protocol)
    jpaddle.save({"f32": jpaddle.to_tensor(ARRAYS["f32"]),
                  "u8": jpaddle.to_tensor(ARRAYS["u8"])},
                 str(tmp_path / "j.pdparams"), protocol=protocol)
    for back in (ppaddle.load(str(tmp_path / "p.pdparams")),
                 jpaddle.load(str(tmp_path / "p.pdparams"))):
        np.testing.assert_array_equal(np.asarray(back["f32"].numpy()),
                                      ARRAYS["f32"])
        np.testing.assert_array_equal(np.asarray(back["i32"].numpy()),
                                      ARRAYS["i32"])
    np.testing.assert_array_equal(
        _bits(ppaddle.load(str(tmp_path / "p.pdparams"))["bf16"]), BF16_BITS)
    back = ppaddle.load(str(tmp_path / "j.pdparams"))
    for k in ("f32", "u8"):
        np.testing.assert_array_equal(_bits(back[k]), ARRAYS[k])


# ---------------------------------------------------------------------------
# a user's script under both packages
# ---------------------------------------------------------------------------

SCRIPT = '''
import numpy as np
import {pkg} as paddle
from {pkg}.models import bert

paddle.set_device("cpu")
cfg = bert.CONFIGS["tiny"]._replace(num_hidden_layers=2,
                                    hidden_dropout_prob=0.0,
                                    attention_probs_dropout_prob=0.0)


def build(seed):
    with paddle.utils.unique_name.guard():
        model = bert.BertForPretraining(cfg)
    model.float()
    rng = np.random.default_rng(seed)
    model.set_state_dict({{k: (rng.standard_normal(v.shape) * 0.05).astype(
        "float32") if len(v.shape) == 2 else v.numpy()
        for k, v in model.state_dict().items()}})
    opt = paddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                    weight_decay=0.01,
                                    parameters=model.parameters())
    return model, opt


rng = np.random.default_rng(1)
ids = paddle.to_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
mlm = paddle.to_tensor(np.where(rng.random((2, 16)) < 0.3,
                                rng.integers(0, cfg.vocab_size, (2, 16)),
                                -100))
nsp = paddle.to_tensor(np.array([0, 1]))
mask = paddle.to_tensor(np.array([[1] * 16, [1] * 12 + [0] * 4]))


def step(model, opt):
    loss = model.loss(ids, mlm, nsp, attention_mask=mask)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss)


model, opt = build(0)
losses = [step(model, opt)]
loss = model.loss(ids, mlm, nsp, attention_mask=mask)
grads = paddle.grad(loss, model.parameters(), retain_graph=True)
loss.backward()
same_grad = all(np.array_equal(g.numpy(), p.grad.numpy())
                for g, p in zip(grads, model.parameters()))
opt.step()
opt.clear_grad()
losses.append(float(loss))
model.eval()
with paddle.no_grad():
    eval_loss = model.loss(ids, mlm, nsp, attention_mask=mask)
model.train()
paddle.save(model.state_dict(), out_dir + "/model.pdparams")
paddle.save(opt.state_dict(), out_dir + "/opt.pdopt")
fresh, fresh_opt = build(7)
missing, unexpected = fresh.set_state_dict(
    paddle.load(out_dir + "/model.pdparams"))
fresh_opt.set_state_dict(paddle.load(out_dir + "/opt.pdopt"))
restored = all(np.array_equal(a.numpy(), b.numpy()) for a, b in zip(
    fresh.state_dict().values(), model.state_dict().values()))
resumed = step(fresh, fresh_opt)
uninterrupted = step(model, opt)
result = dict(losses=losses, eval=float(eval_loss), same_grad=same_grad,
              missing=missing, unexpected=unexpected, restored=restored,
              resumed=resumed, uninterrupted=uninterrupted)
'''


def _run(pkg, out_dir):
    scope = {"out_dir": str(out_dir)}
    exec(compile(SCRIPT.format(pkg=pkg), f"<{pkg} script>", "exec"), scope)
    return scope


def test_a_user_script_gives_the_same_losses_under_both_packages(tmp_path):
    jdir, pdir = tmp_path / "ref", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jscope = _run("paddle_tpu", jdir)
    pscope = _run("paddle_tpu_torch", pdir)
    jres, pres = jscope["result"], pscope["result"]
    # the port's models hand back plain tensors (core/tensor.py)
    assert jscope["eval_loss"].stop_gradient
    assert not pscope["eval_loss"].requires_grad
    for res in (jres, pres):
        assert res["missing"] == [] and res["unexpected"] == []
        assert res["restored"] and res["same_grad"]
        assert res["resumed"] == res["uninterrupted"]
    np.testing.assert_allclose(pres["losses"], jres["losses"], rtol=1e-5)
    np.testing.assert_allclose(pres["eval"], jres["eval"], rtol=1e-5)
    np.testing.assert_allclose(pres["resumed"], jres["resumed"], rtol=1e-5)
    # the port resumes from the reference's checkpoint: model and Momentum
    model, opt = pscope["build"](11)
    assert model.set_state_dict(ppaddle.load(str(jdir / "model.pdparams"))) \
        == ([], [])
    opt.set_state_dict(ppaddle.load(str(jdir / "opt.pdopt")))
    assert opt._global_step == 2
    np.testing.assert_allclose(pscope["step"](model, opt), jres["resumed"],
                               rtol=1e-5)
