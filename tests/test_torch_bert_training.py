"""The port's BERT (MLM + NSP pretraining, key-padding mask) against the
JAX reference.

The reference's tiny BERT is carried across through numpy
(``state_dict`` → ``load_numpy``), and the same seeded batch, with a
padding mask that leaves some rows short, goes through both packages in
fp32: with both dropout rates 0, and at the config's default rates (0.1
and 0.1) with both framework generators seeded alike just before the
step (``paddle_tpu.seed`` / ``paddle_tpu_torch.seed``), so that every
dropout site draws the reference's mask and the generators end in the
same state. The reference runs
as its own tests run it on the CPU: ``FLAGS_flash_attention_interpret``
on, so its attention reaches the Pallas flash kernels (the masked
variant) in interpret mode; the tests parametrised over ``fused`` run
with ``FLAGS_fused_norm`` and ``FLAGS_fused_mlp`` off (the dense norms,
projection and MLP in both packages) and on, with the reference's
``FLAGS_fused_norm_interpret`` and ``FLAGS_fused_mlp_interpret`` (its
LayerNorm, projection-LN and MLP kernels in interpret mode; the port's
fused route, the kernels' plain versions on the CPU). All flags are
restored afterwards.

Tolerances (fp32):
- sequence and pooled outputs, the loss: atol 1e-5 / rtol 1e-4;
- every gradient leaf within 1e-4 of its largest entry: the same f32
  arithmetic in other GEMM and reduction orders, 2 layers;
- three AdamW steps: losses rtol 1e-5; parameters within 2·lr·steps of
  each other entry by entry (Adam divides each gradient by its own
  root-mean-square, so an entry whose gradient is rounding noise moves by
  up to lr per step in either package) and all but 1e-3 of each leaf's
  entries within 1e-6, the key third of each ``qkv.bias`` excepted: its
  gradient is zero in exact arithmetic (it adds the same q·b_k to every
  score of a row, which the softmax cancels), so both packages step it on
  rounding noise;
- the padding invariance: atol 1e-4, the reference test's own.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as paddle
from paddle_tpu.core.flags import get_flag as jax_get_flag
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import bert as jbert
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.nn.functional import mlp as jmlp
from paddle_tpu.nn.functional import norm as jnorm
from paddle_tpu.core import generator as jgen
from paddle_tpu_torch import get_flag as pt_get_flag
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.core import generator as pgen
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import mlp_fusion as pmf
from paddle_tpu_torch.kernels import norm_fusion as pnf
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.nn import functional as PF

B, S = 2, 16
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
_FLAGS = ("flash_attention_interpret", "fused_norm", "fused_norm_interpret",
          "fused_mlp", "fused_mlp_interpret")


def _set_fused(on):
    paddle.set_flags({"FLAGS_fused_norm": on, "FLAGS_fused_norm_interpret": on,
                      "FLAGS_fused_mlp": on, "FLAGS_fused_mlp_interpret": on})
    pt_set_flags({"FLAGS_fused_norm": on, "FLAGS_fused_mlp": on})


@pytest.fixture(scope="module", autouse=True)
def reference_flags():
    old = {n: jax_get_flag(n) for n in _FLAGS}
    old_pt = {n: pt_get_flag(n) for n in ("fused_norm", "fused_mlp")}
    try:
        paddle.set_flags({"FLAGS_flash_attention_interpret": True})
        _set_fused(False)
        mesh_mod.reset_mesh()
        yield
    finally:
        paddle.set_flags({f"FLAGS_{n}": v for n, v in old.items()})
        pt_set_flags({f"FLAGS_{n}": v for n, v in old_pt.items()})
        mesh_mod.reset_mesh()


@pytest.fixture(params=[False, True], ids=["dense", "fused"])
def fused(request):
    _set_fused(request.param)
    try:
        yield request.param
    finally:
        _set_fused(False)


def _numpy(t):
    return np.asarray(t.numpy(), np.float32)


def _cfgs(**kw):
    return (jbert.CONFIGS["tiny"]._replace(**NO_DROPOUT, **kw),
            pbert.CONFIGS["tiny"]._replace(**NO_DROPOUT, **kw))


def _state(jmodel):
    return {k: _numpy(v) for k, v in jmodel.state_dict().items()}


def _pair(cls, seed, **kw):
    """The reference's model of ``cls`` and the port's, carrying its
    weights."""
    jcfg, pcfg = _cfgs()
    paddle.seed(seed)
    jmodel = getattr(jbert, cls)(jcfg, **kw)
    model = getattr(pbert, cls)(pcfg, device="cpu", dtype=torch.float32,
                                **kw).load_numpy(_state(jmodel))
    return jmodel, model


def _batch(seed):
    """ids, MLM labels (-100 off the 30% labelled valid positions), NSP
    labels, and a 1/0 attention mask: row 0 full, row 1 valid up to 10."""
    rng = np.random.default_rng(seed)
    vocab = jbert.CONFIGS["tiny"].vocab_size
    ids = rng.integers(0, vocab, (B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[1, 10:] = 0
    mlm = np.where((rng.random((B, S)) < 0.3) & (mask == 1), ids,
                   -100).astype(np.int64)
    mlm[0, 0] = ids[0, 0]
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return ids, mlm, nsp, mask


def _launches():
    return {**pfa.launches, **pmf.launches, **pnf.launches}


# ---------------------------------------------------------------------------
# the model's parameters
# ---------------------------------------------------------------------------

def test_state_dict_keys_equal_the_reference():
    jcfg, pcfg = _cfgs()
    paddle.seed(0)
    jmodel = jbert.BertForPretraining(jcfg)
    model = pbert.BertForPretraining(pcfg, device="cpu", dtype=torch.float32)
    want = {k: tuple(v.shape) for k, v in jmodel.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert list(got) == list(want)
    assert got == want
    assert [n for n, _ in model.named_parameters()] == list(want)
    # the decoder weight is the word-embedding table itself, no key of its own
    assert (model.cls.decoder_weight
            is model.bert.embeddings.word_embeddings.weight)
    with pytest.raises(KeyError, match="cls.decoder_bias"):
        model.load_numpy({k: v for k, v in _state(jmodel).items()
                          if k != "cls.decoder_bias"})


def test_weights_carry_across_and_init_follows_the_reference():
    jmodel, model = _pair("BertForPretraining", 0)
    state = _state(jmodel)
    for name, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), state[name], err_msg=name)
    emb = model.bert.embeddings.word_embeddings.weight
    np.testing.assert_array_equal(model.cls.decoder_weight.detach().numpy(),
                                  emb.detach().numpy())
    # a fresh port model draws from the reference's distributions
    cfg = pbert.CONFIGS["bert-base"]._replace(num_hidden_layers=1,
                                              vocab_size=4096)
    fresh = pbert.BertForPretraining(cfg, device="cpu", dtype=torch.float32,
                                     seed=3)
    sd = fresh.state_dict()
    H, FF = cfg.hidden_size, cfg.intermediate_size
    for name, fan in (("bert.encoder.0.qkv.weight", H + 3 * H),
                      ("bert.encoder.0.fc2.weight", FF + H),
                      ("cls.transform.weight", H + H)):
        assert abs(float(sd[name].std()) / (2.0 / fan) ** 0.5 - 1) < 0.01
    assert abs(float(sd["bert.embeddings.word_embeddings.weight"].std())
               - 1) < 0.01
    for name in ("bert.encoder.0.qkv.bias", "cls.decoder_bias",
                 "bert.embeddings.layer_norm.bias"):
        assert float(sd[name].abs().max()) == 0.0
    assert torch.equal(sd["bert.encoder.0.attn_ln.weight"], torch.ones(H))
    again = pbert.BertForPretraining(cfg, device="cpu", dtype=torch.float32,
                                     seed=3)
    assert all(torch.equal(a, b) for a, b in zip(sd.values(),
                                                 again.state_dict().values()))


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

def test_sequence_and_pooled_outputs_match(fused):
    jmodel, model = _pair("BertModel", 1)
    ids, _, _, mask = _batch(2)
    jseq, jpooled = jmodel(paddle.to_tensor(ids),
                           attention_mask=paddle.to_tensor(mask))
    with torch.no_grad():
        seq, pooled = model(torch.from_numpy(ids),
                            attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(seq.numpy(), _numpy(jseq), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), _numpy(jpooled), atol=1e-5,
                               rtol=1e-4)


def test_loss_and_every_gradient_match(fused):
    jmodel, model = _pair("BertForPretraining", 3)
    ids, mlm, nsp, mask = _batch(4)
    jloss = jmodel.loss(*map(paddle.to_tensor, (ids, mlm, nsp)),
                        attention_mask=paddle.to_tensor(mask))
    jloss.backward()
    jgrads = {n: _numpy(p.grad) for n, p in jmodel.named_parameters()}
    before = _launches()
    loss = model.loss(*map(torch.from_numpy, (ids, mlm, nsp)),
                      attention_mask=torch.from_numpy(mask))
    loss.backward()
    assert _launches() == before        # CPU: no kernel launches
    assert (jnorm.last_norm_path(), PF.last_norm_path()) == (
        ("fused_ln/interpret", "fused_ln/plain") if fused
        else ("dense", "dense"))        # the MLM transform's LayerNorm
    assert (jmlp.last_mlp_path(), PF.last_mlp_path()) == (
        ("fused_mlp/interpret", "fused_mlp/plain") if fused
        else ("dense", "dense"))
    assert (jattn.last_attn_path(), PF.last_attn_path()) == (
        "flash_masked/interpret", "flash_masked/plain")
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), atol=1e-5,
                               rtol=1e-4)
    assert set(jgrads) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        ref = jgrads[name]
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (name, err)


def test_three_adamw_steps_match_reference(fused):
    """The reference's pretraining loop (tests/test_models.py:31-47):
    model.loss → backward → AdamW step → clear_grad, three times on one
    masked batch."""
    lr, steps = 1e-3, 3
    jmodel, model = _pair("BertForPretraining", 5)
    jopt = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                  parameters=jmodel.parameters())
    opt = popt.AdamW(learning_rate=lr, weight_decay=0.01,
                     parameters=model.parameters())
    ids, mlm, nsp, mask = _batch(6)
    jl, pl = [], []
    for _ in range(steps):
        loss = jmodel.loss(*map(paddle.to_tensor, (ids, mlm, nsp)),
                           attention_mask=paddle.to_tensor(mask))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        loss = model.loss(*map(torch.from_numpy, (ids, mlm, nsp)),
                          attention_mask=torch.from_numpy(mask))
        loss.backward()
        opt.step()
        opt.clear_grad()
        pl.append(loss.item())
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    ref = _state(jmodel)
    H = model.cfg.hidden_size
    for name, p in model.state_dict().items():
        diff = np.abs(p.numpy() - ref[name])
        assert float(diff.max()) <= 2 * lr * steps, name
        if name.endswith("qkv.bias"):       # q and v thirds; k is noise
            diff = np.concatenate([diff[:H], diff[2 * H:]])
        assert float((diff > 1e-6).mean()) <= 1e-3, name
    # the tied decoder weight moved with the embeddings: one tensor
    assert (model.cls.decoder_weight
            is model.bert.embeddings.word_embeddings.weight)


@pytest.mark.parametrize("flag", ["stop_gradient", "trainable"])
def test_a_frozen_parameter_stays_put(flag):
    """Paddle's way to freeze a parameter (``p.stop_gradient = True`` or
    ``p.trainable = False``) on one parameter of each package's tiny BERT:
    after a loss, backward and AdamW step it holds its value, the
    reference's too, and the others step as the reference's do."""
    lr, frozen = 1e-3, "bert.pooler.dense.weight"
    jmodel, model = _pair("BertForPretraining", 7)
    jp = dict(jmodel.named_parameters())[frozen]
    pp = dict(model.named_parameters())[frozen]
    value = flag == "stop_gradient"     # stop_gradient True, trainable False
    setattr(jp, flag, value)
    setattr(pp, flag, value)
    assert pp.requires_grad == (flag == "trainable")
    before = pp.detach().clone()
    jopt = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                  parameters=jmodel.parameters())
    opt = popt.AdamW(learning_rate=lr, weight_decay=0.01,
                     parameters=model.parameters())
    ids, mlm, nsp, mask = _batch(8)
    jmodel.loss(*map(paddle.to_tensor, (ids, mlm, nsp)),
                attention_mask=paddle.to_tensor(mask)).backward()
    jopt.step()
    model.loss(*map(torch.from_numpy, (ids, mlm, nsp)),
               attention_mask=torch.from_numpy(mask)).backward()
    assert (pp.grad is None) == (jp.grad is None) == (flag == "stop_gradient")
    opt.step()
    ref = _state(jmodel)
    assert torch.equal(pp.detach(), before)
    np.testing.assert_array_equal(before.numpy(), ref[frozen])
    for name, p in model.state_dict().items():
        assert float(np.abs(p.numpy() - ref[name]).max()) <= 2 * lr, name


def test_attention_mask_padding_invariance():
    """The reference's test (tests/test_models.py:50-64) on the port: the
    padded, masked sequence gives the unpadded one's outputs."""
    cfg = pbert.CONFIGS["tiny"]
    model = pbert.BertModel(cfg, device="cpu", dtype=torch.float32, seed=1)
    model.eval()
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (1, 8)).astype("int64")
    padded = np.concatenate([ids, np.zeros((1, 4), "int64")], axis=1)
    mask = np.concatenate([np.ones((1, 8)), np.zeros((1, 4))],
                          axis=1).astype("int64")
    with torch.no_grad():
        seq_ref, _ = model(torch.from_numpy(ids))
        seq_pad, _ = model(torch.from_numpy(padded),
                           attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(seq_pad.numpy()[:, :8], seq_ref.numpy(),
                               atol=1e-4)


def test_sequence_classification_in_eval_matches():
    """The default config (dropout 0.1) runs in eval mode."""
    paddle.seed(7)
    jmodel = jbert.BertForSequenceClassification(jbert.CONFIGS["tiny"],
                                                 num_classes=3)
    jmodel.eval()
    model = pbert.BertForSequenceClassification(
        pbert.CONFIGS["tiny"], num_classes=3, device="cpu",
        dtype=torch.float32).load_numpy(_state(jmodel))
    model.eval()
    ids, _, _, mask = _batch(8)
    jlogits = jmodel(paddle.to_tensor(ids),
                     attention_mask=paddle.to_tensor(mask))
    with torch.no_grad():
        logits = model(torch.from_numpy(ids),
                       attention_mask=torch.from_numpy(mask))
    assert logits.shape == (B, 3)
    np.testing.assert_allclose(logits.numpy(), _numpy(jlogits), atol=1e-5,
                               rtol=1e-4)


def _dropout_pair(seed, **rates):
    """The reference's tiny BertForPretraining at the given dropout rates
    (its defaults, 0.1 and 0.1, by default) and the port's carrying its
    weights."""
    jcfg = jbert.CONFIGS["tiny"]._replace(**rates)
    pcfg = pbert.CONFIGS["tiny"]._replace(**rates)
    paddle.seed(seed)
    jmodel = jbert.BertForPretraining(jcfg)
    model = pbert.BertForPretraining(pcfg, device="cpu", dtype=torch.float32
                                     ).load_numpy(_state(jmodel))
    return jmodel, model


def _seed_both(seed):
    paddle.seed(seed)
    pt_seed(seed)


def _same_generator_state():
    np.testing.assert_array_equal(
        pgen.default_generator.get_state().numpy(),
        np.asarray(jgen.default_generator.get_state()).astype(np.int64))


def _loss_and_grads_match(jmodel, model, batch):
    ids, mlm, nsp, mask = batch
    jloss = jmodel.loss(*map(paddle.to_tensor, (ids, mlm, nsp)),
                        attention_mask=paddle.to_tensor(mask))
    jloss.backward()
    loss = model.loss(*map(torch.from_numpy, (ids, mlm, nsp)),
                      attention_mask=torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), atol=1e-5,
                               rtol=1e-4)
    jgrads = {n: _numpy(p.grad) for n, p in jmodel.named_parameters()}
    for name, p in model.named_parameters():
        ref = jgrads[name]
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (name, err)
    return loss.item()


@pytest.mark.parametrize("rate", ["hidden_dropout_prob",
                                  "attention_probs_dropout_prob"])
def test_training_with_one_dropout_rate_matches(rate):
    """One rate at 0.1, the other 0, fused route: the loss and every
    gradient the reference's; the rate-0 sites take no split; eval mode
    runs at any rate."""
    _set_fused(True)
    try:
        jmodel, model = _dropout_pair(9, **{**NO_DROPOUT, rate: 0.1})
        _seed_both(12)
        _loss_and_grads_match(jmodel, model, _batch(9))
        _same_generator_state()
        splits = {"hidden_dropout_prob": 1 + 2 * 2,
                  "attention_probs_dropout_prob": 2}[rate]
        fresh = pgen.Generator(12)
        for _ in range(splits):
            fresh.split_key()
        assert torch.equal(pgen.default_generator.get_state(),
                           fresh.get_state())
    finally:
        _set_fused(False)
    model.eval()
    ids, mlm, nsp, mask = map(torch.from_numpy, _batch(9))
    assert torch.isfinite(model.loss(ids, mlm, nsp, attention_mask=mask))
    assert torch.equal(pgen.default_generator.get_state(), fresh.get_state())


def test_default_config_trains_with_dropout_and_draws_the_reference_masks(
        fused):
    """BertForPretraining at the reference's default rates (0.1 / 0.1):
    the loss and every gradient leaf the reference's, fused and dense
    routes alike (each route draws the reference's masks of that route);
    1 + 3·L generator splits a step, the generators' states equal
    after it; the rates move the loss."""
    jmodel, model = _dropout_pair(3)
    assert (model.cfg.hidden_dropout_prob,
            model.cfg.attention_probs_dropout_prob) == (0.1, 0.1)
    _seed_both(21)
    loss = _loss_and_grads_match(jmodel, model, _batch(4))
    _same_generator_state()
    fresh = pgen.Generator(21)
    for _ in range(1 + 3 * model.cfg.num_hidden_layers):
        fresh.split_key()
    assert torch.equal(pgen.default_generator.get_state(), fresh.get_state())
    assert (jattn.last_attn_path(), PF.last_attn_path()) == (
        "flash_masked/interpret", "flash_masked/plain")
    model.zero_grad()
    with torch.no_grad():
        model.eval()
        ids, mlm, nsp, mask = map(torch.from_numpy, _batch(4))
        assert model.loss(ids, mlm, nsp, attention_mask=mask).item() != loss


def test_three_adamw_steps_with_dropout_match_reference(fused):
    """Three AdamW steps at the default rates, one seed before the first:
    each step draws fresh masks from the advancing generators; losses and
    parameters at the undropped test's tolerances."""
    lr, steps = 1e-3, 3
    jmodel, model = _dropout_pair(5)
    jopt = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                  parameters=jmodel.parameters())
    opt = popt.AdamW(learning_rate=lr, weight_decay=0.01,
                     parameters=model.parameters())
    ids, mlm, nsp, mask = _batch(6)
    _seed_both(33)
    jl, pl = [], []
    for _ in range(steps):
        loss = jmodel.loss(*map(paddle.to_tensor, (ids, mlm, nsp)),
                           attention_mask=paddle.to_tensor(mask))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        loss = model.loss(*map(torch.from_numpy, (ids, mlm, nsp)),
                          attention_mask=torch.from_numpy(mask))
        loss.backward()
        opt.step()
        opt.clear_grad()
        pl.append(loss.item())
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _same_generator_state()
    ref = _state(jmodel)
    H = model.cfg.hidden_size
    for name, p in model.state_dict().items():
        diff = np.abs(p.numpy() - ref[name])
        assert float(diff.max()) <= 2 * lr * steps, name
        if name.endswith("qkv.bias"):       # q and v thirds; k is noise
            diff = np.concatenate([diff[:H], diff[2 * H:]])
        assert float((diff > 1e-6).mean()) <= 1e-3, name


def test_eval_mode_padding_invariance_at_default_dropout():
    """The default config in eval mode: no split, the padded masked
    sequence gives the unpadded one's outputs (the reference test's
    tolerance)."""
    model = pbert.BertModel(pbert.CONFIGS["tiny"], device="cpu",
                            dtype=torch.float32, seed=2)
    model.eval()
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 1024, (2, 8)).astype("int64")
    padded = np.concatenate([ids, np.zeros((2, 4), "int64")], axis=1)
    mask = np.concatenate([np.ones((2, 8)), np.zeros((2, 4))],
                          axis=1).astype("int64")
    pt_seed(1)
    with torch.no_grad():
        seq_ref, _ = model(torch.from_numpy(ids))
        seq_pad, _ = model(torch.from_numpy(padded),
                           attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(seq_pad.numpy()[:, :8], seq_ref.numpy(),
                               atol=1e-4)
    assert torch.equal(pgen.default_generator.get_state(),
                       pgen.Generator(1).get_state())


def test_bf16_model_stays_bf16():
    model = pbert.BertForPretraining(pbert.CONFIGS["tiny"]._replace(
        **NO_DROPOUT), device="cpu", seed=2)
    ids, mlm, nsp, mask = map(torch.from_numpy, _batch(10))
    seq, pooled = model.bert(ids, attention_mask=mask)
    assert seq.dtype == pooled.dtype == torch.bfloat16
    loss = model.loss(ids, mlm, nsp, attention_mask=mask)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    loss.backward()
    assert all(p.grad.dtype == torch.bfloat16 for p in model.parameters())


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pbert.BertForPretraining(pbert.CONFIGS["tiny"])
