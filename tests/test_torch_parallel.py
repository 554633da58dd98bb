"""``qasr_torch.parallel`` in one process, against ``qasr.parallel``: the mesh's
shapes and errors, the sharding rule on every leaf of configs 2, 4 and 5,
the mesh a config asks for, the row and counter helpers, the CTC lattice
functions, and the sharded steps, halo conv and chunked CTC on the 1 x 1
mesh (the one-process functions' bits). The worlds of 2 and 4 ranks are
``tests/test_torch_parallel_worlds.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.configs import get_config as jget_config
from qasr.ops import ctc as jctc
from qasr.parallel import make_mesh as jmake_mesh
from qasr.parallel.sharding import _sharding_for
from qasr.train.loop import build_mesh_from_config as jbuild_mesh
from qasr.train.state import build_model as jbuild_model
from qasr_torch.configs import get_config
from qasr_torch.models import build_model
from qasr_torch.models.layers import Dropout
from qasr_torch.ops import ctc
from qasr_torch.ops.qlinalg import qconv
from qasr_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    aggregate_per,
    allsum_across_hosts,
    create_sharded_train_state,
    ctc_loss_seq_parallel,
    host_rows,
    make_mesh,
    make_sharded_train_step,
    param_spec,
    qconv2d_seq_parallel,
    shard_batch,
    tree_shardings,
)
from qasr_torch.train.loop import mesh_shape
from qasr_torch.train.metrics import per_device_bytes, state_bytes
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import train_step
from tests import torch_parallel_worker as worker

torch.set_num_threads(1)
EIGHT = list(range(8))


@pytest.mark.parametrize("n_data,n_model", [(-1, 1), (-1, 2), (4, 2), (2, 4), (-1, 8), (1, 8)])
def test_make_mesh_shapes(n_data, n_model):
    got = make_mesh(n_data, n_model, ranks=EIGHT)
    want = jmake_mesh(n_data, n_model)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names) == (DATA_AXIS, MODEL_AXIS)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.ranks, ids)
    assert got.coords == (0, 0) and got.groups == {}  # one process: no groups


@pytest.mark.parametrize("n_data,n_model", [(-1, 3), (3, 2), (4, 4)])
def test_make_mesh_errors(n_data, n_model):
    with pytest.raises(ValueError) as want:
        jmake_mesh(n_data, n_model)
    with pytest.raises(ValueError) as got:
        make_mesh(n_data, n_model, ranks=EIGHT)
    assert str(got.value) == str(want.value)


def test_default_mesh_is_one_rank():
    mesh = make_mesh()
    assert mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1} and mesh.coords == (0, 0)
    assert mesh.index(DATA_AXIS) == mesh.index(MODEL_AXIS) == 0


def _jax_leaves(cfg) -> dict:
    """name -> ShapeDtypeStruct of every parameter of the JAX model, by
    eval_shape (no weights drawn)."""
    model = jbuild_model(cfg)
    x = jnp.zeros((1, 16, cfg.data.n_mels, 4), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))["params"]
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return {".".join(str(k.key) for k in path): (path, leaf) for path, leaf in flat}


@pytest.mark.parametrize("preset", ["timit_qcnn", "librispeech_qlstm", "librispeech_large"])
@pytest.mark.parametrize("n_model", [2, 4])
def test_param_spec_matches_reference(preset, n_model):
    """Every leaf of the port's model (built on the meta device) gets the
    reference's spec on a mesh with ``n_model`` model ranks, the fallback to
    replicated where the axis does not divide Cout included."""
    jleaves = _jax_leaves(jget_config(preset))
    model = build_model(get_config(preset), device="meta")
    named = dict(model.named_parameters())
    assert named.keys() == jleaves.keys()
    jmesh = jmake_mesh(8 // n_model, n_model)
    specs = tree_shardings(make_mesh(8 // n_model, n_model, ranks=EIGHT), model)
    split = 0
    for name, p in named.items():
        path, leaf = jleaves[name]
        assert tuple(p.shape) == tuple(leaf.shape), name
        want = tuple(_sharding_for(jmesh, path, leaf).spec)
        assert specs[name] == want, (name, specs[name], want)
        assert param_spec(tuple(name.split(".")), p) in (want, (None,) * (p.ndim - 1) + (MODEL_AXIS,))
        split += bool(want)
    assert split > 0


@pytest.mark.parametrize("data_axis,model_axis", [(-1, 1), (-1, 4), (-1, 3), (-1, 16), (2, 2),
                                                  (1, 8), (2, 8), (3, 3)])
def test_mesh_from_config_clamps_as_reference(data_axis, model_axis):
    """The model axis clamped to the largest divisor of the rank count; an
    explicit data axis takes exactly its ranks, and more than exist raise."""
    over = {"mesh.data_axis": data_axis, "mesh.model_axis": model_axis}
    cfg, jcfg = get_config("tiny_synthetic").override(**over), jget_config(
        "tiny_synthetic").override(**over)
    try:
        want = jbuild_mesh(jcfg)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_shape(cfg, 8)
        assert str(got.value) == str(e)
        return
    n_data, n_model, used = mesh_shape(cfg, 8)
    assert {DATA_AXIS: n_data, MODEL_AXIS: n_model} == dict(want.shape)
    assert used == want.devices.size


def test_host_rows_and_counters_in_one_process():
    batch = {"labels": np.arange(12).reshape(6, 2), "real_rows": np.ones(6, bool)}
    assert host_rows(batch) is batch
    assert host_rows(batch, make_mesh()) is batch
    np.testing.assert_array_equal(allsum_across_hosts(np.array([3, 4])), [3, 4])
    assert aggregate_per(5, 17) == (5, 17)
    # the rows of rank 0 on a 4 x 2 grid: the first quarter
    sub = shard_batch(make_mesh(4, 2, ranks=EIGHT), batch | {"labels": np.arange(16)})
    np.testing.assert_array_equal(sub["labels"], [0, 1, 2, 3])


def _ctc_inputs(seed=0, b=4, t=24, v=9, l=5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, v).astype(np.float32)
    labels = rng.randint(1, v, size=(b, l)).astype(np.int32)
    labels[1, 1] = labels[1, 0]  # a repeat: no skip there
    ll = np.asarray([t, t - 5, t // 2, 3], np.int32)
    tl = np.asarray([l, l - 1, 2, 0], np.int32)
    return logits, labels, ll, tl


def test_lattice_functions_match_reference():
    logits, labels, ll, tl = _ctc_inputs()
    got = ctc.build_lattice(torch.from_numpy(labels).long(), torch.from_numpy(tl).long(),
                            blank_id=0)
    want = jctc.build_lattice(jnp.asarray(labels), jnp.asarray(tl), blank_id=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    z, can_skip, in_lattice, s_valid = got
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    em = ctc.lattice_emissions(logp, z)
    jem = jctc.lattice_emissions(jnp.asarray(logp.numpy()), jnp.asarray(z.numpy()))
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    b, s = z.shape
    a0 = ctc.alpha_pre(b, s)
    np.testing.assert_array_equal(a0.numpy(), np.asarray(jctc.alpha_pre(b, s)))
    step = ctc.make_alpha_step(can_skip, in_lattice, torch.from_numpy(ll).long())
    jstep = jctc.make_alpha_step(*(jnp.asarray(a.numpy()) for a in (can_skip, in_lattice)),
                                 jnp.asarray(ll))
    alpha, jalpha = a0, jnp.asarray(a0.numpy())
    for t in range(logits.shape[1]):
        alpha, _ = step(alpha, (em[:, t], t))
        jalpha, _ = jstep(jalpha, (jem[:, t], t))
        np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=1e-5)
    got_ll = ctc.loglik_from_alpha(alpha, s_valid, torch.from_numpy(tl).long())
    want_ll = jctc.loglik_from_alpha(jalpha, jnp.asarray(s_valid.numpy()), jnp.asarray(tl))
    np.testing.assert_allclose(got_ll.numpy(), np.asarray(want_ll), rtol=1e-5)
    np.testing.assert_allclose(-got_ll.numpy(), np.asarray(jctc.ctc_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(ll), jnp.asarray(tl))), rtol=1e-5)


def test_seq_parallel_ops_on_one_rank():
    """On the 1 x 1 mesh the halo conv is the SAME conv (zeros for halos)
    and the chunked CTC is the whole-sequence loss, gradients included."""
    mesh = make_mesh()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 12, 5, 16, generator=g)
    w = torch.randn(4, 3, 5, 4, 8, generator=g) * 0.2
    for variant in ("block", "fast8"):
        got = qconv2d_seq_parallel(x, w, mesh, variant=variant)
        torch.testing.assert_close(got, qconv(x, w), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="odd"):
        qconv2d_seq_parallel(x, torch.zeros(4, 2, 3, 4, 8), mesh)
    logits, labels, ll, tl = (torch.from_numpy(a) for a in _ctc_inputs(1))
    lg = logits.clone().requires_grad_(True)
    loss = ctc_loss_seq_parallel(lg, labels, ll, tl, mesh)
    loss.sum().backward()
    lg2 = logits.clone().requires_grad_(True)
    want = ctc.ctc_loss(lg2, labels, ll, tl)
    want.sum().backward()
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lg.grad, lg2.grad, rtol=1e-4, atol=1e-6)


def test_dropout_draws_the_global_batch_mask():
    """A rank's rows of the global batch, given as ``global_rows``, get the
    rows of the whole batch's mask, and the generator ends where the whole
    batch's draw leaves it."""
    d = Dropout(0.4)
    x = torch.randn(6, 5, 8)
    whole = d(x, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    part = d(x[2:4], gen, (2, 6))
    torch.testing.assert_close(part, whole[2:4], rtol=0, atol=0)
    assert torch.equal(gen.get_state(), _after_draw((6, 5, 8), 3).get_state())


def _after_draw(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    torch.rand(shape, generator=gen)
    return gen


def test_sharded_step_on_one_rank_gives_the_one_process_bits():
    cfg = worker.tiny_config(**{"model.dropout_rate": 0.2})
    ds_batches = worker_batches(cfg)
    single = create_train_state(cfg, device="cpu")
    state, specs = create_sharded_train_state(cfg, make_mesh(), device="cpu")
    assert set(specs) == set(dict(state.model.named_parameters()))
    step = make_sharded_train_step(cfg, make_mesh())
    for b in ds_batches:
        m1, m2 = train_step(single, b), step(state, b)
        for k in ("loss", "grad_norm", "frames"):
            assert torch.equal(m1[k], m2[k]), k
    for (k, p), q in zip(single.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(p, q), k
    persistent, gathered = state_bytes(state, cpu=True)
    assert gathered == {} and persistent == per_device_bytes(
        (single.model.state_dict(), single.optimizer.state_dict()), cpu=True)
    assert per_device_bytes(single.model.state_dict()) == {}  # CPU tensors: not counted


def worker_batches(cfg):
    from qasr_torch.data.batching import epoch_iterator
    from qasr_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(vocab=cfg.model.vocab, n_mels=cfg.data.n_mels,
                          num_examples=cfg.data.num_synthetic, seed=0)
    return list(epoch_iterator(ds, cfg.data, train=False))[:2]
