"""The port's error taxonomy (``core/errors.py``), places
(``core/place.py``), ``framework``, ``base.ParamAttr`` and
``core/strings.py`` against the reference's.

- Errors: the twelve classes with the reference's codes and builtin
  bases; ``enforce*`` raise the same classes with the same messages; a
  handful of bad arguments to the ops raise the reference's exception
  class with the reference's message.
- Places: ``CPUPlace`` / ``CUDAPlace`` map to torch devices, ``set_device``
  and ``get_device`` set and read the place of new tensors (creation and
  random ops and the ``Tensor`` / ``Parameter`` constructors of host
  data land there), ``is_compiled_with_cuda`` is whether a card is
  present, and ``TPUPlace`` / ``set_device("tpu")`` raise the reference's
  "unknown device" error instead of falling back to the CPU. Without a
  card the default place (the card) raises on first use.
- ``framework.get_default_dtype`` / ``set_default_dtype`` steer the
  creation ops; ``ParamAttr`` and ``StringTensor`` behave as the
  reference's.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as paddle
from paddle_tpu.core import errors as jerrors
from paddle_tpu.core import strings as jstrings
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import errors as perrors
from paddle_tpu_torch.core import place as pplace
from paddle_tpu_torch.core import strings as pstrings


@pytest.fixture(autouse=True)
def restore_place():
    prev = pplace._CURRENT_PLACE[0]
    yield
    pplace._CURRENT_PLACE[0] = prev
    pt.set_default_dtype("float32")
    paddle.set_default_dtype("float32")


def test_error_classes_and_codes_match_the_reference():
    assert set(perrors.BY_CODE) == set(jerrors.BY_CODE)
    for code, jcls in jerrors.BY_CODE.items():
        pcls = perrors.BY_CODE[code]
        assert pcls.__name__ == jcls.__name__ and pcls.code == code
        assert [b.__name__ for b in pcls.__mro__] == \
            [b.__name__ for b in jcls.__mro__]


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 (the class is what is compared)
        return type(e), str(e)
    raise AssertionError("no exception")


ENFORCE = [
    ("enforce", lambda m: m.enforce(False, "x must be positive")),
    ("enforce-class", lambda m: m.enforce(0, "gone", m.NotFoundError)),
    ("enforce_eq", lambda m: m.enforce_eq(3, 4, "shapes")),
    ("enforce_eq-bare", lambda m: m.enforce_eq("a", "b")),
    ("enforce_not_none", lambda m: m.enforce_not_none(None, "weight")),
]


@pytest.mark.parametrize("case", ENFORCE, ids=[c[0] for c in ENFORCE])
def test_enforce_raises_the_reference_error(case):
    jt, jmsg = _raised(lambda: case[1](jerrors))
    pt_, pmsg = _raised(lambda: case[1](perrors))
    assert pt_.__name__ == jt.__name__ and pmsg == jmsg


X = np.arange(12, dtype=np.float32).reshape(3, 4)

BAD = [
    ("t-3d", lambda m: m.t(m.zeros([2, 2, 2]))),
    ("where-one-arg", lambda m: m.where(m.to_tensor(X) > 1)),
    ("split-uneven", lambda m: m.split(m.to_tensor(np.zeros(5)), 2)),
    ("meshgrid-kwarg", lambda m: m.meshgrid(m.to_tensor(X[0]), foo=1)),
    ("put_along_axis-reduce", lambda m: m.put_along_axis(
        m.to_tensor(X), m.to_tensor(np.zeros((3, 1), np.int64)),
        m.to_tensor(np.ones((3, 1), np.float32)), 1, reduce="bogus")),
    ("unique_consecutive-axis", lambda m: m.unique_consecutive(
        m.to_tensor(X), axis=0)),
    ("set_default_dtype", lambda m: m.set_default_dtype("int32")),
    ("set_device-unknown", lambda m: m.set_device("abc:0")),
    ("set_device-type", lambda m: m.set_device(3)),
    ("create_array", lambda m: m.create_array(initialized_list=3)),
    ("array_read", lambda m: m.array_read([], 0)),
    ("array_write", lambda m: m.array_write(m.to_tensor(X), 2, [])),
]


@pytest.mark.parametrize("case", BAD, ids=[c[0] for c in BAD])
def test_bad_arguments_raise_the_reference_error(case):
    pt.set_device("cpu")
    jt, jmsg = _raised(lambda: case[1](paddle))
    pt_, pmsg = _raised(lambda: case[1](pt))
    assert (pt_.__name__, pmsg) == (jt.__name__, jmsg)


def test_strings_match_the_reference():
    data = [["Ab", "ÄÖ"], ["x1", ""]]
    js, ps = jstrings.StringTensor(data), pstrings.StringTensor(data)
    assert ps.shape == js.shape and ps.dtype == js.dtype and ps.numel() == 4
    for fn in ("strings_lower", "strings_upper"):
        for utf8 in (True, False):
            assert getattr(pstrings, fn)(ps, utf8).tolist() == \
                getattr(jstrings, fn)(js, utf8).tolist()
    assert pstrings.strings_empty([2]).tolist() == ["", ""]
    assert pstrings.strings_copy(ps) == ps and ps[0, 1] == "ÄÖ"
    with pytest.raises(TypeError) as e:
        pstrings.StringTensor([1])
    assert str(e.value) == "StringTensor holds str only; got int"


def test_param_attr_matches_the_reference():
    from paddle_tpu.base.param_attr import ParamAttr as J
    P = pt.ParamAttr
    for arg in (None, "w", False, [None, "b"]):
        j, p = J._to_attr(arg), P._to_attr(arg)
        if isinstance(j, list):
            assert [a.name for a in p] == [a.name for a in j]
        elif j is False:
            assert p is False
        else:
            assert vars(p) == vars(j)
    init = object()
    assert P._to_attr(init).initializer is init


def test_places_and_devices():
    assert pt.CPUPlace().torch_device() == torch.device("cpu")
    assert pt.CUDAPlace(1) == pt.CUDAPlace(1) != pt.CPUPlace(1)
    assert pt.is_compiled_with_cuda() == torch.cuda.is_available()
    pt.set_device("cpu")
    assert pt.get_device() == "cpu"
    for make in (lambda: pt.zeros([2]), lambda: pt.rand([2]),
                 lambda: pt.to_tensor([1, 2]), lambda: pt.arange(3),
                 lambda: pt.randint(0, 5, [3]), lambda: pt.eye(2),
                 lambda: pt.Tensor(np.ones((2, 3), np.float32)),
                 lambda: pt.Tensor([1, 2]),
                 lambda: pt.Parameter(np.ones(3, np.float32))):
        t = make()
        assert t.device.type == "cpu" and t.place == pt.CPUPlace()
    # a torch tensor keeps its device; an explicit place wins
    assert pt.Tensor(torch.ones(2)).device.type == "cpu"
    assert pt.Tensor(np.ones(2), place="cpu").place == pt.CPUPlace()
    assert pt.Tensor(np.ones(2), place=pt.CPUPlace()).place == pt.CPUPlace()
    # the reference's error for a device that is not there; no fallback
    for bad in (lambda: pt.set_device("tpu"), lambda: pt.TPUPlace(0),
                lambda: pt.set_device("tpu:1"), lambda: pt.XPUPlace(0)):
        with pytest.raises(ValueError, match="unknown device"):
            bad()
    assert pt.get_device() == "cpu"
    with pytest.raises(ValueError) as je:
        paddle.set_device("abc")
    with pytest.raises(ValueError) as pe:
        pt.set_device("abc")
    assert str(pe.value) == str(je.value)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the "
                    "behaviour without a card")
def test_the_default_place_is_the_card_and_fails_loudly_without_one():
    pplace._CURRENT_PLACE[0] = None
    assert pt.get_device() == "gpu:0"
    for make in (lambda: pt.zeros([2]), lambda: pt.to_tensor([1.0]),
                 lambda: pt.rand([2]), lambda: pt.set_device("gpu"),
                 lambda: pt.Tensor(np.ones(2, np.float32)),
                 lambda: pt.Tensor([1.0]),
                 lambda: pt.Parameter(np.ones(2, np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make()


def test_default_dtype_steers_the_creation_ops():
    pt.set_device("cpu")
    assert pt.framework.get_default_dtype() == torch.float32
    pt.framework.set_default_dtype("float64")
    paddle.framework.set_default_dtype("float64")
    assert pt.zeros([1]).dtype == torch.float64
    assert pt.to_tensor([1.5]).dtype == torch.float64
    assert pt.full([1], 0.5).dtype == torch.float64
    assert pt.framework.in_dynamic_mode()
