"""The port's PV-tuning CLI (aqlm_tpu_torch.cli.finetune) and its host-side
modules (pv.host, pv.teacher, io.train_state, utils.monitoring) against
aqlm_tpu's on the CPU.

One dense teacher and one 2x8 student (a tiny 2-layer Llama, f32, random
weights from JAX) are written by ``aqlm_tpu.io`` once per module; both CLIs
train the student on them from one seed (4 steps of 2 x 2 microbatches of
16 random ids, a V step every 2 steps with code_lr 5e-2, so codes move).
JAX's CLI takes only ``random:`` or an HF directory as its teacher, so its
``resolve_model`` is wrapped to call the teacher directory dense.

Stated tolerances: per-step KL within rtol 1e-4 of JAX's, saved codes
identical, the port's checkpoint read by ``aqlm_tpu``'s loader equal to the
port's final state; ``--resume`` from the step-2 training state equal to
the uninterrupted run (KL rtol 1e-4, codes identical); ``--offload_teacher``
(the teacher streamed in its own dtype) equal to the plain run, and with
``--st_window 1`` equal to JAX's ``--st_window 1`` run (the same tolerances:
the host Adam is JAX's); ``HostSTManager`` against JAX's within rtol 1e-6.
"""

import functools
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, to_numpy_tree

from aqlm_tpu.cli import finetune as jcli
from aqlm_tpu.config import SCHEME_2X8 as J2X8
from aqlm_tpu.io import load_quantized_model as j_load
from aqlm_tpu.io import save_quantized_model as j_save
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models.quantize import random_quantize_projections as j_random_quantize
from aqlm_tpu.pv.host import HostSTManager as JHostSTManager
from aqlm_tpu.pv.teacher import HostTeacher as JHostTeacher
from aqlm_tpu_torch.cli import finetune as cli
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.io import load_quantized_model
from aqlm_tpu_torch.io.checkpoint import _loadz
from aqlm_tpu_torch.io.train_state import load_pytree, save_pytree
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.pv import PVConfig, configurable_adamw, init_pv_state, make_pv_step
from aqlm_tpu_torch.pv.host import HostSTManager
from aqlm_tpu_torch.pv.teacher import HostTeacher, TeacherPrefetcher
from aqlm_tpu_torch.pv.trainer import tree_leaves
from aqlm_tpu_torch.utils import MetricLogger, device_memory_stats, print_runtime_stats

TINY = dict(num_layers=2, hidden_size=64, intermediate_size=128)
RUN = ["--dataset", "random", "--nsamples", "8", "--model_seqlen", "16", "--batch_size", "4",
       "--microbatch_size", "2", "--total_steps", "4", "--code_update_every", "2",
       "--code_lr", "5e-2", "--max_code_change_per_step", "0.25", "--loss_tokens_per_chunk", "8",
       "--seed", "3"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune")
    cfg = jllama.ModelConfig.tiny(**TINY)
    teacher = jllama.init_random_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    student = j_random_quantize(jax.random.PRNGKey(1), jax.tree.map(lambda x: x, teacher), J2X8)
    paths = {"teacher": str(root / "teacher"), "student": str(root / "student"), "root": root}
    j_save(paths["teacher"], teacher, cfg)
    j_save(paths["student"], student, cfg)
    return paths


def _argv(dirs, out, *extra):
    return ["--base_model", dirs["teacher"], "--quantized_model", dirs["student"], *RUN,
            "--save", str(out), *extra]


def _run_jax(dirs, out, *extra, monkeypatch):
    resolve = jcli.resolve_model

    def as_dense(spec, **kw):
        params, cfg, kind = resolve(spec, **kw)
        return params, cfg, "dense" if spec == dirs["teacher"] else kind

    monkeypatch.setattr(jcli, "resolve_model", as_dense)
    out_res = jcli.main(_argv(dirs, out, *extra))
    monkeypatch.undo()
    return out_res


def _codes(path):
    out = {}
    for li in range(TINY["num_layers"]):
        arrays = _loadz(os.path.join(path, f"layer_{li}.npz"))
        out.update({f"{li}.{k}": v.numpy() for k, v in arrays.items() if k.endswith(".codes")})
    return out


@pytest.fixture(scope="module")
def runs(dirs):
    """The port's plain run (saving the training state every 2 steps) and JAX's."""
    mp = pytest.MonkeyPatch()
    root = dirs["root"]
    port = cli.main(_argv(dirs, root / "port", "--save_state_every", "2", "--device", "cpu"))
    jax_res = _run_jax(dirs, root / "jax", monkeypatch=mp)
    return {"port": port, "jax": jax_res, "port_dir": str(root / "port"),
            "jax_dir": str(root / "jax")}


def test_cli_matches_jax(dirs, runs):
    port, jres = runs["port"], runs["jax"]
    assert len(port["step_losses"]) == 4 and all(np.isfinite(port["step_losses"]))
    np.testing.assert_allclose(port["step_losses"], jres["losses"], rtol=1e-4)
    np.testing.assert_allclose(port["final_kl"], jres["final_kl"], rtol=1e-4)
    got, want = _codes(runs["port_dir"]), _codes(runs["jax_dir"])
    assert got.keys() == want.keys() and len(got) == 14
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    start = _codes(dirs["student"])
    assert sum(int((got[k] != start[k]).any(-1).sum()) for k in got) > 0  # V steps moved codes
    assert set(port["seconds"]) == {"grad", "apply", "code"} and len(port["seconds"]["code"]) == 2


def test_port_checkpoint_loads_in_jax(runs):
    jp, jcfg = j_load(runs["port_dir"])
    p, cfg = load_quantized_model(runs["port_dir"], device="cpu")
    assert jcfg.num_layers == cfg.num_layers == 2
    for li in range(2):
        for name in llama.QUANTIZABLE_PROJS:
            jq, q = jp["layers"][li][name], p["layers"][li][name]
            np.testing.assert_array_equal(np.asarray(jq.codes), q.codes.numpy())
            np.testing.assert_array_equal(np.asarray(jq.codebooks), f32(q.codebooks))
    np.testing.assert_array_equal(np.asarray(jp["embed"]), f32(p["embed"]))


def test_resume_equals_uninterrupted_run(dirs, runs, tmp_path):
    out = tmp_path / "resumed"
    argv = _argv(dirs, out, "--save_state_every", "2", "--device", "cpu")
    first = cli.main([*argv[:argv.index("--total_steps") + 1], "2",
                      *argv[argv.index("--total_steps") + 2:]])
    assert os.path.exists(out / "train_state.npz")
    resumed = cli.main(argv + ["--resume"])
    np.testing.assert_allclose(first["step_losses"] + resumed["step_losses"],
                               runs["port"]["step_losses"], rtol=1e-4)
    got, want = _codes(str(out)), _codes(runs["port_dir"])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_offload_teacher_equals_plain_run(dirs, runs, tmp_path):
    res = cli.main(_argv(dirs, tmp_path / "off", "--offload_teacher", "--teacher_stream_group", "3",
                         "--device", "cpu"))
    np.testing.assert_allclose(res["step_losses"], runs["port"]["step_losses"], rtol=1e-5)
    got, want = _codes(str(tmp_path / "off")), _codes(runs["port_dir"])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_st_window_matches_jax(dirs, tmp_path, monkeypatch):
    res = cli.main(_argv(dirs, tmp_path / "port", "--st_window", "1", "--offload_teacher",
                         "--device", "cpu"))
    jres = _run_jax(dirs, tmp_path / "jax", "--st_window", "1", monkeypatch=monkeypatch)
    np.testing.assert_allclose(res["step_losses"], jres["losses"], rtol=1e-4)
    got, want = _codes(str(tmp_path / "port")), _codes(str(tmp_path / "jax"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


UNPORTED = [(["--mesh_data", "2"], "A14"), (["--mesh_model", "2"], "A14"),
            (["--wandb"], "A15"),
            (["--eval_every_steps", "1", "--eval_datasets", "wikitext2"], "A11")]


@pytest.mark.parametrize("flags,item", UNPORTED, ids=[" ".join(f) for f, _ in UNPORTED])
def test_unported_flags_raise_their_item(dirs, tmp_path, flags, item):
    argv = _argv(dirs, tmp_path / "x", *flags, "--device", "cpu")
    argv[argv.index("--total_steps") + 1] = "1"
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv)


def test_eval_every_steps_on_the_val_split(dirs, tmp_path, capsys):
    argv = _argv(dirs, tmp_path / "ev", "--val_size", "2", "--eval_every_steps", "2",
                 "--eval_datasets", "random", "--device", "cpu")
    argv[argv.index("--total_steps") + 1] = "2"
    cli.main(argv)
    out = capsys.readouterr().out
    assert "step 1: val ppl=" in out and "step 1: random ppl=" in out


# --- the modules -----------------------------------------------------------------


@functools.cache
def _students():
    cfg = jllama.ModelConfig.tiny(num_layers=3, hidden_size=64, intermediate_size=128)
    jp = j_random_quantize(jax.random.PRNGKey(2),
                           jllama.init_random_params(jax.random.PRNGKey(4), cfg, dtype=jnp.float32),
                           J2X8)
    return jp, params_from_numpy(to_numpy_tree(jp), device="cpu")


@pytest.mark.parametrize("moments", ["f32", "f16"])
def test_host_st_manager_matches_jax(moments):
    jp, p = _students()
    np_dt, t_dt = (np.float32, torch.float32) if moments == "f32" else (np.float16, torch.float16)
    jm = JHostSTManager(jp, window=2, lr=0.1, moment_dtype=np_dt)
    m = HostSTManager(p, window=2, lr=0.1, moment_dtype=t_dt)
    for step in range(3):
        assert m.active_window(step) == jm.active_window(step)
    for li in range(3):
        for name, buf in jm.buffers[li].items():
            np.testing.assert_allclose(m.buffers[li][name].numpy(), buf, rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(0)
    for step in range(3):
        active = m.active_window(step)
        g = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in e.items()}
             if i in active else {} for i, e in enumerate(jm.buffers)]
        jm.adam_update(active, g)
        m.adam_update(active, [{k: torch.from_numpy(v) for k, v in e.items()} for e in g])
    for li in range(3):
        for name, buf in jm.buffers[li].items():
            np.testing.assert_allclose(m.buffers[li][name].numpy(), buf, rtol=1e-6, atol=1e-7)
            assert m.m[li][name].dtype == t_dt
    fetched = m.fetch((2,))
    assert fetched[0] == {} and set(fetched[2]) == set(llama.QUANTIZABLE_PROJS)
    win = m.fetch_window((0, 1))
    assert win["q_proj"].shape[0] == 2
    back = m.window_to_list((0, 1), win)
    assert torch.equal(back[1]["q_proj"], m.buffers[1]["q_proj"]) and back[2] == {}
    m.store((2,), [{}, {}, {k: v * 0 for k, v in fetched[2].items()}])
    assert not m.buffers[2]["q_proj"].any()


def test_host_teacher_and_prefetcher():
    cfg = jllama.ModelConfig.tiny(**TINY)
    jt = jllama.init_random_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    t = params_from_numpy(to_numpy_tree(jt), device="cpu")
    pcfg = llama.ModelConfig.tiny(**TINY)
    ht = HostTeacher(t, pcfg, dtype=torch.float32, device="cpu")
    jht = JHostTeacher(jt, cfg, dtype=jnp.float32)
    batches = [np.random.default_rng(i).integers(0, 256, (2, 16)) for i in range(5)]
    many = ht.hidden_many(batches)
    for ids, h in zip(batches, many):
        want, _ = llama.forward(t, pcfg, torch.from_numpy(ids), return_hidden=True)
        torch.testing.assert_close(h, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(h.numpy(), np.asarray(jht.hidden(jnp.asarray(ids))), rtol=1e-4,
                                   atol=1e-5)
    got = list(TeacherPrefetcher(ht, iter(batches), group_size=2, depth=1))
    assert len(got) == 5
    for (ids, tin), ref, h in zip(got, batches, many):
        np.testing.assert_array_equal(np.asarray(ids), ref)
        assert torch.equal(tin["hidden"], h) and tin["embed"] is None
        assert torch.equal(tin["head"], t["lm_head"].weight)
    endless = TeacherPrefetcher(ht, itertools.repeat(batches[0]), group_size=2, depth=1)
    assert all(torch.equal(next(endless)[1]["hidden"], many[0]) for _ in range(3))
    endless.close(timeout=30)
    assert not endless._thread.is_alive()


def test_train_state_round_trip(tmp_path):
    _, p = _students()
    cfg = llama.ModelConfig.tiny(num_layers=3, hidden_size=64, intermediate_size=128)
    pv = PVConfig(chunk_tokens=8, max_code_change_per_step=0.25, code_lr=5e-2)
    make = lambda: init_pv_state(p, configurable_adamw(1e-3, amsgrad=True,
                                                       exp_avg_dtype=torch.bfloat16),
                                 configurable_adamw(pv.code_lr), active_layers=(0, 2))
    fns = make_pv_step(cfg, cfg, pv)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 16)))
    state = make()
    state, _ = fns.grad_step(state, p, ids)
    state = fns.code_step(state)
    path = str(tmp_path / "state.npz")
    save_pytree(path, state, metadata={"step": 1})
    restored, meta = load_pytree(path, make())
    assert meta == {"step": 1}
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())
    for opt in ("cont_opt", "st_opt"):
        sa = getattr(state, opt).state_dict()["state"]
        sb = getattr(restored, opt).state_dict()["state"]
        assert sa.keys() == sb.keys()
        for k in sa:
            for name, v in sa[k].items():
                assert (torch.equal(v, sb[k][name]) and v.dtype == sb[k][name].dtype
                        if isinstance(v, torch.Tensor) else v == sb[k][name])
    # the restored optimizers hold the restored state's tensors: a further step agrees
    a, la = fns.grad_step(state, p, ids)
    b, lb = fns.grad_step(restored, p, ids)
    assert float(la) == float(lb)
    for x, y in zip(tree_leaves(a.trainable), tree_leaves(b.trainable)):
        assert torch.equal(x.detach(), y.detach())


def test_metric_logger_and_monitoring(tmp_path, capsys):
    path = str(tmp_path / "logs" / "m.jsonl")
    log = MetricLogger(jsonl_path=path)
    log.log({"kl_loss": 0.5}, step=0)
    log.log({"ppl_val": 3.0}, step=10)
    with open(path) as f:
        assert [json.loads(x) for x in f] == [{"step": 0, "kl_loss": 0.5},
                                              {"step": 10, "ppl_val": 3.0}]
    MetricLogger().log({"a": 1}, step=2)
    assert json.loads(capsys.readouterr().out.strip()) == {"step": 2, "a": 1}
    with pytest.raises(NotImplementedError, match="A15"):
        MetricLogger(use_wandb=True)
    with print_runtime_stats("phase"):
        pass
    assert "phase took" in capsys.readouterr().out
    assert device_memory_stats("cpu") == {"bytes_in_use": None, "peak_bytes_in_use": None,
                                          "bytes_limit": None}
