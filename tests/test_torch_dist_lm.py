"""The port's dense decoders sharded over rank processes, against the JAX
package on one device, on the CPU (gloo ranks, smollm-360m's SMOKE config:
2 layers, d 60, 3 heads, 1 kv head, f32).

On 2x2 the embed dim is cut over ``data`` (FSDP), the mlp and vocab over
``model`` (tensor parallel), the 3 heads replicated and the decode cache's
head_dim cut; on 1x3 the heads are cut (the kv head whole).  One spawn of
4 ranks runs the 2x2 checks, then re-cuts itself into (pod 2, data 1,
model 2) for the compressed step and into 4x1; one spawn of 3 ranks runs
the 1x3 checks.  Held, with the JAX package's weights carried over:

* the collectives on 2 and 4 ranks, forward and backward, bf16 and int64
  through the wire's 4-byte words;
* ``lm_loss`` (1e-5 relative) and its gathered gradients (1e-4 of each
  leaf's max) on 2x2 and 1x3; remat changes no bit; in bf16 the loss
  parts from one device's only where a model axis cuts a product;
* six steps of the train step at 1 and 2 microbatches on 2x2 (losses
  within 1e-4, gnorms 1e-4 relative, final params 1e-4 of their max);
* the compressed step on (pod 2, data 1, model 2) against the JAX
  package's own ``make_train_step`` on 4 fake CPU devices, run in a child
  process (losses within 1e-4 over 3 steps, params 1e-4 relative in norm,
  each residual element within one quantization step; step 0's int8
  levels of each pod's gradient, a scale a layer-stacked tensor, agree but
  for a counted few at a rounding boundary);
* greedy serving on 2x2 and 1x3 (the same tokens, logits within 1e-5 of
  JAX's prefill and decode);
* qwen1.5-4b's and gemma-2b's smoke configs on 2x2 (heads cut over
  ``model``; qwen's kv heads and qkv biases cut, gemma's one kv head
  whole) against the JAX package: the loss, its gradients and serving at
  the tolerances above;
* checkpoints: a 1x1 one and the JAX trainer's resume on 2x2, a 2x2 one
  on 1x1 (losses within 1e-4 of the uninterrupted runs);
* the launchers: ``train.main --mesh 2x2`` prints the 1x1 lines,
  ``serve.main --mesh 2x2`` gives the 1x1 tokens.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import dist
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.distributed import collectives as C
from repro_torch.distributed import compression as comp
from repro_torch.launch import mesh as M
from repro_torch.launch import serve, train
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax_sharded
from repro_torch.optim import adamw
from repro_torch.training import train_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "smollm-360m"
B, S, SEED = 4, 32, 0
KW = dict(lr=3e-4, warmup_steps=5, total_steps=6)
COMP_STEPS = 3
OTHER_ARCHS = ("qwen1.5-4b", "gemma-2b")
GEN, PROMPT = 6, 16
# launcher runs: 8 steps scheduled; checkpoints every 3, halted after 6
TRAIN = ["--arch", ARCH, "--smoke", "--steps", "8", "--batch", "4", "--seq", "32",
         "--log-every", "1", "--device", "cpu"]


def _jax_params(jcfg):
    import jax

    from repro.models import init_model as jax_init
    return jax_init(jcfg, jax.random.PRNGKey(SEED))[0]


def _tokens(cfg, seed=0, b=B, s=S):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s)).astype(np.int32)


def _batches(cfg, n):
    pipe = pipeline.Pipeline(pipeline.DataConfig(vocab=cfg.vocab, seq_len=S,
                                                 global_batch=B))
    return [pipe.batch_for_step(i) for i in range(n)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# --------------------------------------------------------------------------
# the JAX side: the compressed step on 4 fake devices (a child process)
# --------------------------------------------------------------------------


def _jax_compressed(out: str) -> None:
    from repro.launch.mesh import ensure_host_devices
    ensure_host_devices(4)
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.distributed import compression as jcomp
    from repro.launch.mesh import make_dev_mesh
    from repro.models.transformer import RunCfg as JaxRun
    from repro.optim import adamw as jax_adamw
    from repro.training import train_loop as jax_train
    from repro_torch.models.convert import port_leaves

    from repro.models.transformer import lm_loss as jax_lm_loss
    from repro_torch.models.convert import port_leaves

    jcfg = jax_config(ARCH, smoke=True)
    jp = _jax_params(jcfg)
    out_d = {}
    # step 0's int8 levels of each pod's gradient (its rows, one device;
    # a scale a tensor, stacked over the layers), and the gradient in
    # units of its level before the rounding
    tokens = _batches(jcfg, 1)[0]["tokens"]
    for pod in range(2):
        rows = tokens[pod * B // 2:(pod + 1) * B // 2]
        g = jax.grad(lambda p: jax_lm_loss(jcfg, JaxRun(mesh=None, remat=False), p,
                                           {"tokens": jnp.asarray(rows)}))(jp)
        qs = jax.tree.map(lambda x: jcomp.quantize_int8(x), g)
        is_pair = lambda t: isinstance(t, tuple)  # noqa: E731
        levels = jax.tree.map(lambda t: np.asarray(t[0]), qs, is_leaf=is_pair)
        units = jax.tree.map(lambda x, t: np.asarray(x, np.float32) / np.asarray(t[1]),
                             g, qs, is_leaf=is_pair)
        for name, q in port_leaves(levels).items():
            out_d[f"q0/{pod}/{name}"] = q
        for name, x in port_leaves(units).items():
            out_d[f"x0/{pod}/{name}"] = x
    mesh = make_dev_mesh(data=1, model=2, pod=2)
    run = JaxRun(mesh=mesh, data_axes=("pod", "data"), model_axes=("model",),
                 remat=False)
    tc = jax_train.TrainCfg(grad_compression=True, adamw=jax_adamw.AdamWConfig(**KW))
    step = jax.jit(jax_train.make_train_step(jcfg, run, tc))
    state = jax_adamw.init(tc.adamw, jp)
    res = jcomp.init_residuals(jp)
    for i, batch in enumerate(_batches(jcfg, COMP_STEPS)):
        jp, state, res, m = step(jp, state, res, {k: jnp.asarray(x) for k, x in batch.items()})
        out_d[f"loss/{i}"] = np.asarray(m["loss"])
        out_d[f"gnorm/{i}"] = np.asarray(m["grad_norm"])
        if i == 0:
            for name, x in port_leaves(jax.tree.map(np.asarray, jp)).items():
                out_d[f"param0/{name}"] = x
    for name, x in port_leaves(jax.tree.map(np.asarray, jp)).items():
        out_d[f"param/{name}"] = x
    for name, x in port_leaves(jax.tree.map(np.asarray, res)).items():
        out_d[f"res/{name}"] = x
    np.savez(out, **out_d)


# --------------------------------------------------------------------------
# the port's ranks
# --------------------------------------------------------------------------


def _collectives(ctx, axes_list):
    """Each collective over each axis of ``axes_list``: forward against
    the expected values, backward through the autograd forms, bf16 and
    int64 carried bitwise."""
    mesh = M.mesh_of(ctx)
    out = {}
    for axis in axes_list:
        p, me = mesh.shape[axis], mesh.coords[axis]
        gen = torch.Generator().manual_seed(7)
        xs = [torch.randn(2 * p, 3, generator=gen) for _ in range(p)]  # rank j's
        x = xs[me]
        ok = {}
        ok["all_gather"] = torch.equal(C.all_gather(x, axis, 0), torch.cat(xs, 0))
        want = xs[0]
        for y in xs[1:]:
            want = want + y
        ok["reduce_scatter"] = torch.equal(C.reduce_scatter(x, axis, 0),
                                           torch.chunk(want, p, 0)[me])
        ok["all_reduce_sum"] = torch.equal(C.all_reduce(x, axis, "sum"), want)
        ok["all_reduce_max"] = torch.equal(C.all_reduce(x, axis, "max"),
                                           torch.stack(xs).amax(0))
        b16 = x.to(torch.bfloat16)[:, :1]   # an odd count of 2-byte elements
        ok["bf16_gather"] = torch.equal(C.all_gather(b16, axis, 1),
                                        torch.cat([y.to(torch.bfloat16)[:, :1]
                                                   for y in xs], 1))
        ids = torch.arange(5, dtype=torch.int64) + 10 ** 12 * me
        ok["int64_gather"] = torch.equal(C.all_gather(ids, axis, 0), torch.cat(
            [torch.arange(5, dtype=torch.int64) + 10 ** 12 * j for j in range(p)]))
        # backward: gather <-> reduce-scatter; reduce_from: identity;
        # copy_to: an all-reduce of the gradient
        w = x.clone().requires_grad_()
        u = x[:1].clone().requires_grad_()
        gw, gu = C.gather_packed([w, u], [0, 1], axis)
        ((gw * (me + 1)).sum() + (gu * torch.arange(p * 3.0)).sum()).backward()
        ok["gather_backward"] = torch.equal(w.grad, torch.full_like(x, p * (p + 1) / 2)) \
            and torch.equal(u.grad, p * torch.arange(me * 3.0, me * 3.0 + 3)[None])
        w = x.clone().requires_grad_()
        (C.reduce_from(w, axis) * (me + 1)).sum().backward()
        ok["reduce_from_backward"] = torch.equal(w.grad, torch.full_like(x, me + 1.0))
        w = x.clone().requires_grad_()
        (C.copy_to(w, axis) * (me + 1)).sum().backward()
        ok["copy_to_backward"] = torch.equal(
            w.grad, torch.full_like(x, p * (p + 1) / 2))
        out[f"{axis}/{p}"] = ok
    return out


def _gathered_grads(cfg, run, model, toks):
    model.requires_grad_(True)
    loss = T.lm_loss(cfg, run, model, {"tokens": T.local_rows(toks, run)})
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    full = C.gather_full(grads, T.param_specs(cfg, run.mesh))
    return loss.detach(), {n: g.numpy() for n, g in full.items()}


def _run(ctx, remat=False):
    return T.RunCfg(mesh=M.mesh_of(ctx), remat=remat)


def _loss_grads(ctx, cfg, jparams, toks):
    run = _run(ctx)
    model = params_from_jax_sharded(cfg, jparams, run.mesh, device="cpu")
    loss, grads = _gathered_grads(cfg, run, model, toks)
    # remat (one checkpoint a layer, the gather inside it) changes no bit
    rcfg = __import__("dataclasses").replace(cfg, remat=True)
    loss_r, grads_r = _gathered_grads(rcfg, _run(ctx, remat=True), model, toks)
    same = bool(torch.equal(loss, loss_r)) and all(
        np.array_equal(grads[n], grads_r[n]) for n in grads)
    return {"loss": float(loss), "grads": grads, "remat_bitwise": same}


def _trajectory(ctx, cfg, jparams, microbatches):
    run = _run(ctx)
    model = params_from_jax_sharded(cfg, jparams, run.mesh, device="cpu")
    tc = train_loop.TrainCfg(microbatches=microbatches, adamw=adamw.AdamWConfig(**KW))
    step = train_loop.make_train_step(cfg, run, tc)
    state = adamw.init(tc.adamw, dict(model.named_parameters()))
    losses, gnorms = [], []
    for batch in _batches(cfg, 6):
        loss, m = step(model, state, {k: torch.from_numpy(x) for k, x in batch.items()})
        losses.append(float(loss))
        gnorms.append(float(m["grad_norm"]))
    full = C.gather_full({n: p.detach() for n, p in model.named_parameters()},
                         T.param_specs(cfg, run.mesh))
    return {"losses": losses, "gnorms": gnorms,
            "params": {n: p.numpy() for n, p in full.items()}}


def _levels0(cfg, run, model, specs):
    """Step 0's int8 levels of each pod's gradient as the compressed step
    computes it (the pod's rows, the data axes without ``pod``), gathered
    whole, and the gradient in units of its level before the rounding:
    ``{(pod, name): (levels, units)}``."""
    import dataclasses

    inner = dataclasses.replace(run, per_pod=True)
    tokens = torch.from_numpy(_batches(cfg, 1)[0]["tokens"])
    model.requires_grad_(True)
    names, leaves = zip(*model.named_parameters())
    out = {}
    for pod in range(run.mesh.shape["pod"]):
        n = B // run.mesh.shape["pod"]
        loss = T.lm_loss(cfg, inner, model, {"tokens": tokens[pod * n:(pod + 1) * n]})
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        full = C.gather_full(grads, specs)
        scales = comp.tensor_scales(full)
        for name, g in full.items():
            q = comp.quantize_at(g, scales[name])
            out[(pod, name)] = (q.numpy(), (g / scales[name]).numpy())
    return out


def _compressed(ctx, cfg, jparams):
    run = _run(ctx)
    model = params_from_jax_sharded(cfg, jparams, run.mesh, device="cpu")
    specs = T.param_specs(cfg, run.mesh)
    levels = _levels0(cfg, run, model, specs)
    tc = train_loop.TrainCfg(grad_compression=True, adamw=adamw.AdamWConfig(**KW))
    step = train_loop.make_train_step(cfg, run, tc)
    state = adamw.init(tc.adamw, dict(model.named_parameters()))
    res = comp.init_residuals(dict(model.named_parameters()))
    losses, gnorms, params = [], [], []
    for batch in _batches(cfg, COMP_STEPS):
        loss, m, res = step(model, state, res,
                            {k: torch.from_numpy(x) for k, x in batch.items()})
        losses.append(float(loss))
        gnorms.append(float(m["grad_norm"]))
        full = C.gather_full({n: p.detach() for n, p in model.named_parameters()}, specs)
        params.append({n: p.numpy().copy() for n, p in full.items()})
    full_r = C.gather_full(res, specs)
    return {"losses": losses, "gnorms": gnorms, "pod": run.mesh.coords["pod"],
            "params": params, "levels0": levels,
            "residuals": {n: r.numpy() for n, r in full_r.items()}}


def _serving(ctx, cfg, jparams):
    run = _run(ctx)
    model = params_from_jax_sharded(cfg, jparams, run.mesh, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, seed=5, s=PROMPT))
    r = serve.generate(cfg, run, model, toks, GEN, keep_logits=True)
    return {"tokens": r["tokens"].numpy(), "logits": [x.numpy() for x in r["logits"]]}


def _loss_gaps(ctx, cfg, jparams, toks):
    """The loss's gap to one device's in f32 and in bf16 compute."""
    import dataclasses

    run = _run(ctx)
    out = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        model = params_from_jax_sharded(c, jparams, run.mesh, device="cpu")
        one = T.init_model(c, device="meta").to_empty(device="cpu")
        one.load_state_dict(dict(C.gather_full(dict(model.named_parameters()),
                                               T.param_specs(c, run.mesh))))
        with torch.no_grad():
            got = float(T.lm_loss(c, run, model, {"tokens": T.local_rows(toks, run)}))
            want = float(T.lm_loss(c, T.RunCfg(), one, {"tokens": toks}))
        out[dtype] = abs(got - want) / abs(want)
    return out


def _other_archs(ctx, jtrees):
    """qwen1.5-4b's and gemma-2b's smoke configs (4 heads: cut over
    ``model``; qwen's 4 kv heads cut with them and its qkv biases, the
    cache's kv heads cut; gemma's one kv head whole, read by each local
    query head, its weights' gradients summed over ``model``, the cache's
    head_dim cut) on this mesh, with the JAX package's weights carried
    over: the loss and its gathered gradients, and greedy serving."""
    run = _run(ctx)
    out = {}
    for arch, jparams in jtrees.items():
        cfg = get_config(arch, smoke=True)
        model = params_from_jax_sharded(cfg, jparams, run.mesh, device="cpu")
        toks = torch.from_numpy(_tokens(cfg, seed=2))
        loss, grads = _gathered_grads(cfg, run, model, toks)
        model.requires_grad_(False)
        r = serve.generate(cfg, run, model, toks[:, :PROMPT], GEN, keep_logits=True)
        out[arch] = {"tp": (T.attn_tp(cfg, run, cache=True).cache_dim,
                            T.mlp_tp(cfg, run).axes),
                     "loss": float(loss), "grads": grads,
                     "tokens": r["tokens"].numpy(),
                     "logits": [x.numpy() for x in r["logits"]]}
    return out


def _launch(ctx, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = train.train(train.parse_args(argv), ctx)
    return {"losses": losses, "stdout": out.getvalue()}


def _ranks_2x2(ctx, jparams, toks, dirs, others):
    M.share_host(ctx)
    cfg = get_config(ARCH, smoke=True)
    out = {"collectives": _collectives(ctx, ["data", "model"]),
           "loss_grads": _loss_grads(ctx, cfg, jparams, toks),
           "dtype_gaps": {"2x2": _loss_gaps(ctx, cfg, jparams, toks)},
           "trajectory": {mb: _trajectory(ctx, cfg, jparams, mb) for mb in (1, 2)},
           "serving": _serving(ctx, cfg, jparams),
           "other_archs": _other_archs(ctx, others),
           "from_1x1": _launch(ctx, TRAIN + ["--mesh", "2x2", "--ckpt-dir",
                                             dirs["port"], "--halt-after", "6"]),
           "from_jax": _launch(ctx, TRAIN + ["--mesh", "2x2", "--ckpt-dir",
                                             dirs["jax"], "--halt-after", "6"]),
           "writes": _launch(ctx, TRAIN + ["--mesh", "2x2", "--ckpt-dir", dirs["2x2"],
                                           "--ckpt-every", "3", "--halt-after", "4"])}
    ctx = M.regrid_mesh({"pod": 2, "data": 1, "model": 2})
    out["compressed"] = _compressed(ctx, cfg, jparams)
    ctx = M.regrid_mesh({"data": 4, "model": 1})
    out["collectives"].update(_collectives(ctx, ["data"]))
    out["dtype_gaps"]["4x1"] = _loss_gaps(ctx, cfg, jparams, toks)
    return out


def _ranks_1x3(ctx, jparams, toks):
    M.share_host(ctx)
    cfg = get_config(ARCH, smoke=True)
    run = _run(ctx)
    assert T.attn_tp(cfg, run).axes == ("model",)       # the heads are cut
    args = serve.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--mesh", "1x3"])
    return {"loss_grads": _loss_grads(ctx, cfg, jparams, toks),
            "serving": _serving(ctx, cfg, jparams),
            "serve_tokens": serve.serve(args, ctx)}


# --------------------------------------------------------------------------
# the runs, once for the module
# --------------------------------------------------------------------------


def _start(argv, env=None):
    env = dict(os.environ if env is None else env, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, *argv], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return out


def _step_losses(stdout):
    return {int(line.split()[1]): float(line.split()[3])
            for line in stdout.splitlines() if line.startswith("step")}


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models import decode_step as jax_decode
    from repro.models import prefill as jax_prefill
    from repro.models.transformer import RunCfg as JaxRun
    from repro.models.transformer import lm_loss as jax_lm_loss
    from repro.optim import adamw as jax_adamw
    from repro.training import train_loop as jax_train
    from repro_torch.models.convert import port_leaves

    tmp = tempfile.mkdtemp()
    dirs = {k: os.path.join(tmp, k) for k in ("port", "jax", "2x2")}
    comp_out = os.path.join(tmp, "compressed.npz")
    children = {
        "compressed": _start([os.path.abspath(__file__), comp_out]),
        "jax_train": _start(["-m", "repro.launch.train", *TRAIN[:-2], "--ckpt-dir",
                             dirs["jax"], "--ckpt-every", "3", "--halt-after", "6"]),
    }
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp = _jax_params(jcfg)
    jtree = jax.tree.map(np.asarray, jp)
    jrun = JaxRun(mesh=None, remat=False)
    toks = _tokens(cfg)
    got, want = {}, {}
    # the 1x3 ranks run while this process computes the JAX side
    one_by_three = threading.Thread(target=lambda: got.update({"1x3": dist.run_ranks(
        _ranks_1x3, 1, 3, device="cpu", args=(jtree, torch.from_numpy(toks)))[0]}))
    one_by_three.start()
    for mb in (1, 2):
        jt = jax_train.TrainCfg(microbatches=mb, adamw=jax_adamw.AdamWConfig(**KW))
        jstep = jax.jit(jax_train.make_train_step(jcfg, jrun, jt))
        p, st, hist = jp, jax_adamw.init(jt.adamw, jp), []
        for batch in _batches(cfg, 6):
            p, st, m = jstep(p, st, {k: jnp.asarray(x) for k, x in batch.items()})
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        want[f"trajectory/{mb}"] = (hist, port_leaves(jax.tree.map(np.asarray, p)))
    def jax_serving(jc, params, ptoks):
        lg, cache = jax_prefill(jc, jrun, params, {"tokens": jnp.asarray(ptoks)},
                                t_max=PROMPT + GEN)
        logits = [np.asarray(lg)]
        for _ in range(GEN - 1):
            tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
            lg, cache = jax_decode(jc, jrun, params, cache, tok)
            logits.append(np.asarray(lg))
        return logits

    def jax_loss_grads(jc, params, t):
        loss, g = jax.value_and_grad(
            lambda p: jax_lm_loss(jc, jrun, p, {"tokens": jnp.asarray(t)}))(params)
        return float(loss), port_leaves(jax.tree.map(np.asarray, g))

    want["loss"], want["grads"] = jax_loss_grads(jcfg, jp, toks)
    want["serving"] = jax_serving(jcfg, jp, _tokens(cfg, seed=5, s=PROMPT))
    # qwen1.5-4b and gemma-2b: the same weights go to the 2x2 ranks
    others = {}
    for arch in OTHER_ARCHS:
        oc = jax_config(arch, smoke=True)
        op = _jax_params(oc)
        others[arch] = jax.tree.map(np.asarray, op)
        t = _tokens(get_config(arch, smoke=True), seed=2)
        loss_o, g_o = jax_loss_grads(oc, op, t)
        want[f"other/{arch}"] = {"loss": loss_o, "grads": g_o,
                                 "serving": jax_serving(oc, op, t[:, :PROMPT])}

    # the port's 1x1 runs: uninterrupted, and halted with checkpoints at 0, 3
    quiet = io.StringIO()
    with contextlib.redirect_stdout(quiet):
        want["port_1x1"] = train.main(TRAIN)
        train.main(TRAIN + ["--ckpt-dir", dirs["port"], "--ckpt-every", "3",
                            "--halt-after", "6"])
        want["serve_1x1"] = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    want["jax_train"] = _step_losses(_finish(children.pop("jax_train")))
    got["2x2"] = dist.run_ranks(_ranks_2x2, 2, 2, device="cpu",
                                args=(jtree, torch.from_numpy(toks), dirs, others))[0]
    one_by_three.join(timeout=600)
    assert "1x3" in got, "the 1x3 ranks failed"
    # the 2x2 checkpoint (step 3) resumed on one device
    with contextlib.redirect_stdout(quiet):
        got["1x1_from_2x2"] = train.main(TRAIN + ["--ckpt-dir", dirs["2x2"],
                                                  "--halt-after", "6"])
    _finish(children.pop("compressed"))
    with np.load(comp_out) as z:
        want["compressed"] = dict(z)
    shutil.rmtree(tmp, ignore_errors=True)
    return got, want


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------


def test_collectives_on_2_and_4_ranks(runs):
    got, _ = runs
    checks = got["2x2"]["collectives"]
    assert sorted(checks) == ["data/2", "data/4", "model/2"]
    for key, ok in checks.items():
        assert all(ok.values()), (key, ok)


@pytest.mark.parametrize("mesh", ["2x2", "1x3"])
def test_lm_loss_and_gradients_match_jax(runs, mesh):
    got, want = runs
    lg = got[mesh]["loss_grads"]
    assert abs(lg["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert set(lg["grads"]) == set(want["grads"])
    for name, g in lg["grads"].items():
        assert _rel(g, want["grads"][name]) <= 1e-4, name
    assert lg["remat_bitwise"]


def test_bf16_gap_comes_from_the_row_parallel_sums(runs):
    # in bf16 a model axis rounds each rank's partial row-parallel product
    # to bf16 before the sum (as GSPMD's bf16 all-reduce does), where one
    # device rounds the whole product once; the data axes only reorder
    # f32 sums, and in f32 the model axis changes nothing either
    got, _ = runs
    gaps = got["2x2"]["dtype_gaps"]
    assert gaps["4x1"]["bfloat16"] <= 1e-6 and gaps["4x1"]["float32"] <= 1e-6
    assert gaps["2x2"]["float32"] <= 1e-6
    assert 1e-6 < gaps["2x2"]["bfloat16"] <= 1e-3


@pytest.mark.parametrize("microbatches", [1, 2])
def test_six_step_trajectory_on_2x2_matches_jax(runs, microbatches):
    got, want = runs
    traj = got["2x2"]["trajectory"][microbatches]
    hist, params = want[f"trajectory/{microbatches}"]
    for i, (loss, gnorm) in enumerate(hist):
        assert abs(traj["losses"][i] - loss) <= 1e-4, (i, traj["losses"][i], loss)
        assert abs(traj["gnorms"][i] - gnorm) <= 1e-4 * gnorm
    for name, p in params.items():
        assert _rel(traj["params"][name], p) <= 1e-4, name


def test_compressed_step_matches_jax_on_4_fake_devices(runs):
    got, want = runs
    c, ref = got["2x2"]["compressed"], want["compressed"]
    assert c["pod"] == 0
    for i in range(COMP_STEPS):
        assert abs(c["losses"][i] - float(ref[f"loss/{i}"])) <= 1e-4, i
        assert abs(c["gnorms"][i] - float(ref[f"gnorm/{i}"])) <= 1e-4 * float(ref[f"gnorm/{i}"])
    # step 0's int8 levels of each pod's gradient: the packages' f32
    # gradients differ in the last places, so an element whose gradient
    # lies on a rounding boundary between two levels may round the other
    # way; every other level agrees
    flips, total, worst = 0, 0, 0.0
    for (pod, name), (q, x) in c["levels0"].items():
        qj, xj = ref[f"q0/{pod}/{name}"].astype(np.int32), ref[f"x0/{pod}/{name}"]
        assert q.shape == qj.shape, name
        diff = q.astype(np.int32) != qj
        total += q.size
        flips += int(diff.sum())
        assert np.all(np.abs(q.astype(np.int32) - qj)[diff] == 1), name
        # the unrounded level of each flipped element, in both packages,
        # lies at a half-integer
        edge = np.abs(np.abs(np.concatenate([x[diff], xj[diff]])) % 1.0 - 0.5)
        worst = max(worst, float(edge.max(initial=0.0)))
        assert np.allclose(x, xj, rtol=0, atol=1e-3), name
    print(f"compressed step 0: {flips} of {total} int8 levels flipped, each "
          f"within {worst:.2e} of a rounding boundary")
    assert flips <= 1e-3 * total and worst <= 1e-3
    # params 1e-4 relative in norm after step 0 and after the last step
    gaps = {}
    for when, key in ((0, "param0"), (COMP_STEPS - 1, "param")):
        for name, p in c["params"][when].items():
            w = ref[f"{key}/{name}"]
            gaps[(when, name)] = float(np.linalg.norm(p - w) / np.linalg.norm(w))
    worst = max(gaps, key=gaps.get)
    print("compressed step: params' largest gap in norm", worst, gaps[worst])
    assert gaps[worst] <= 1e-4, (worst, gaps[worst])
    for name, r in c["residuals"].items():
        w = ref[f"res/{name}"]
        # each residual lies within half a quantization step of zero, so
        # the two maxima sum to about one step (10% slack for small leaves)
        step = 1.1 * (float(np.abs(w).max()) + float(np.abs(r).max()))
        assert float(np.abs(r - w).max()) <= step, name
        assert float(np.abs(r).max()) > 0, name


@pytest.mark.parametrize("mesh", ["2x2", "1x3"])
def test_serving_matches_jax(runs, mesh):
    got, want = runs
    s = got[mesh]["serving"]
    greedy = [np.argmax(x[:, -1], -1) for x in want["serving"]]
    assert np.array_equal(s["tokens"], np.stack(greedy, 1))
    for a, b in zip(s["logits"], want["serving"]):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("arch,cache_dim", [("qwen1.5-4b", 3), ("gemma-2b", 4)])
def test_other_dense_archs_on_2x2_match_one_device(runs, arch, cache_dim):
    # the JAX package on one device, on the same weights: qwen's kv heads
    # and qkv biases cut over model, gemma's one kv head whole under cut
    # query heads; decode with the cache's kv heads (qwen) or head_dim
    # (gemma) cut
    got, want = runs
    r, w = got["2x2"]["other_archs"][arch], want[f"other/{arch}"]
    assert r["tp"] == (cache_dim, ("model",))
    assert abs(r["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
    assert set(r["grads"]) == set(w["grads"])
    for name, g in r["grads"].items():
        assert _rel(g, w["grads"][name]) <= 1e-4, name
    greedy = [np.argmax(x[:, -1], -1) for x in w["serving"]]
    assert np.array_equal(r["tokens"], np.stack(greedy, 1))
    for a, b in zip(r["logits"], w["serving"]):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-5


def test_serve_on_1x3_gives_the_1x1_tokens(runs):
    got, want = runs
    assert np.array_equal(got["1x3"]["serve_tokens"], want["serve_1x1"].numpy())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_2x2_resumes_a_one_device_checkpoint(runs, writer):
    got, want = runs
    run = got["2x2"]["from_1x1" if writer == "port" else "from_jax"]
    assert "[resume] from step 3" in run["stdout"] and "[halt]" in run["stdout"]
    ref = (dict(enumerate(want["port_1x1"])) if writer == "port"
           else want["jax_train"])
    assert len(run["losses"]) == 2
    for step, loss in zip((4, 5), run["losses"]):
        assert abs(loss - ref[step]) < 1e-4, (writer, step, loss, ref[step])


def test_1x1_resumes_a_2x2_checkpoint(runs):
    got, want = runs
    wrote = got["2x2"]["writes"]
    assert wrote["losses"] == pytest.approx(want["port_1x1"][:4], abs=1e-5)
    assert got["1x1_from_2x2"] == pytest.approx(want["port_1x1"][4:6], abs=1e-4)


def test_train_main_on_2x2_prints_the_1x1_lines(capfd):
    one = train.main(TRAIN + ["--steps", "3"])
    lines_1 = capfd.readouterr().out
    two = train.main(TRAIN + ["--steps", "3", "--mesh", "2x2"])
    lines_2 = capfd.readouterr().out
    assert two == pytest.approx(one, abs=1e-5)
    # the same lines; their printed numbers at the lines' own rounding
    got = [line.rsplit("(", 1)[0].split() for line in lines_2.splitlines()
           if line.startswith(("step", "[done]"))]
    want = [line.rsplit("(", 1)[0].split() for line in lines_1.splitlines()]
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if a == b:
                continue
            assert abs(float(a) - float(b)) <= 1.01 * 10 ** -len(b.split(".")[1]), (g, w)


def test_serve_main_on_2x2_gives_the_1x1_tokens(runs):
    got, want = runs
    tokens = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "2x2"])
    assert torch.equal(tokens, want["serve_1x1"])


if __name__ == "__main__":
    _jax_compressed(sys.argv[1])
