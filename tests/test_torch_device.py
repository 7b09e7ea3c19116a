"""``paddle.device`` (``paddle_tpu_torch/device/__init__.py``) against
the reference's, on the CPU.

The device queries, ``set_device`` / ``get_device`` and the memory
statistics read what the reference reads on a backend with no card
(``["cpu"]``, ``"cpu"``, zeros); ``synchronize`` and ``empty_cache``
return. Streams and events are real CUDA streams here, where the
reference's are no-ops: without a card, constructing one raises (checked
here); on the card ``chip_smoke.py`` phase 54 runs a forward under
``stream_guard`` with an ``Event`` handoff. The top-level namespace:
``import paddle_tpu_torch as paddle`` gives the ported subpackages and
names, and an unported name of the reference's namespace raises
AttributeError naming its ROADMAP item.
"""
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as jpaddle
import paddle_tpu_torch as ppaddle
import torch_ops_audit as A

NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="checks the behaviour without a card")


@pytest.fixture(autouse=True)
def cpu_place():
    yield from A.cpu_place()


@NO_CARD
def test_queries_match_the_reference_without_a_card():
    jd, pd = jpaddle.device, ppaddle.device
    for fn in ("get_all_device_type", "get_all_custom_device_type",
               "get_available_custom_device"):
        assert getattr(pd, fn)() == getattr(jd, fn)(), fn
    # the reference counts its host's virtual devices (the test mesh's
    # eight); the port counts cards
    assert pd.get_available_device() == ["cpu:0"]
    assert pd.device_count() == 0
    jd.set_device("cpu")
    assert pd.set_device("cpu") == ppaddle.CPUPlace()
    assert pd.get_device() == jd.get_device() == "cpu"
    for fn in ("memory_allocated", "max_memory_allocated", "memory_reserved",
               "max_memory_reserved"):
        assert getattr(pd.cuda, fn)() == 0, fn
    pd.cuda.reset_max_memory_allocated()
    pd.cuda.empty_cache()
    pd.synchronize()
    pd.cuda.synchronize()
    assert pd.cuda.device_count() == 0
    assert not pd.is_compiled_with_tpu()


@NO_CARD
def test_streams_and_events_need_a_card():
    pd = ppaddle.device
    for make in (pd.Stream, pd.Event, pd.cuda.Stream, pd.cuda.Event,
                 lambda: pd.Stream(priority=1)):
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            make()
    with pd.stream_guard(None):
        pass
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pd.set_device("gpu:0")


@NO_CARD
def test_entry_points_follow_the_current_place():
    """``device=None`` resolves through ``core.place.default_device``
    alone: the CPU after ``set_device("cpu")``, and the place's own card
    (``cuda:1`` for ``gpu:1``) otherwise, which raises without one."""
    from paddle_tpu_torch._device import resolve_device
    from paddle_tpu_torch.core import place
    assert resolve_device() == place.default_device() == torch.device("cpu")
    assert ppaddle.nn.Linear(2, 3).weight.device == torch.device("cpu")
    place._CURRENT_PLACE[0] = place.CUDAPlace(1)
    with pytest.raises(RuntimeError, match="'cuda:1' requested but no CUDA "
                       "GPU is available; pass device=\"cpu\""):
        resolve_device()
    with pytest.raises(RuntimeError, match="'cuda:1'"):
        ppaddle.nn.Linear(2, 3)


def test_the_namespace():
    paddle = ppaddle
    for name in ("nn", "optimizer", "amp", "vision", "device", "autograd",
                 "framework", "base", "incubate", "inference", "models",
                 "profiler", "utils"):
        assert hasattr(paddle, name), name
    assert paddle.nn.Layer is paddle.nn.layer.layers.Layer
    for name in ("Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb", "LBFGS",
                 "NAdam", "RAdam", "ASGD", "Rprop", "AdamW", "Momentum"):
        assert hasattr(paddle.optimizer, name), name
    for name in ("save", "load", "grad", "no_grad", "enable_grad",
                 "set_grad_enabled", "is_grad_enabled", "LazyGuard",
                 "disable_signal_handler", "get_cuda_rng_state",
                 "set_cuda_rng_state"):
        assert hasattr(paddle, name) and hasattr(jpaddle, name), name
    assert paddle.autograd.PyLayer is not None
    with paddle.LazyGuard():
        pass
    assert paddle.disable_signal_handler() is None
    state = paddle.get_cuda_rng_state()
    paddle.set_cuda_rng_state(state)
    assert hasattr(paddle, "metric") and hasattr(paddle, "create_parameter")
    for name, item in (("jit", "A9"), ("static", "A9"), ("distributed", "A10"),
                       ("io", "A11"), ("hapi", "A11")):
        assert hasattr(jpaddle, name)
        assert not hasattr(paddle, name), name
        with pytest.raises(AttributeError, match=f"ROADMAP {item}"):
            getattr(paddle, name)
    with pytest.raises(AttributeError, match="no attribute 'nonesuch'"):
        paddle.nonesuch  # noqa: B018
