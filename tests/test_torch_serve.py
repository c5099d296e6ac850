"""The port's serving path against the JAX model, on the CPU.

The JAX smoke model's weights (one model, no node dimension) move through
``repro_torch.convert`` and both models run on the same numpy-made
tokens:

* ``Model.prefill``: last-token logits and every cache leaf, with naive
  and chunked attention (the JAX chunked path is the jnp scan
  ``_chunked_attention``; the port's is the flash kernel's plain
  version).  float32 within 1e-5 of the largest value: the two
  frameworks sum matmuls and softmaxes in other orders, and the chunked
  paths tile K by 1024 (JAX) and 128 (the port).  bfloat16 within 3e-2:
  bf16 keeps 8 bits (2^-8 = 3.9e-3 relative), and a product rounded the
  other way at one place moves later layers by a few ulp; the measured
  gap is 1.0e-2 naive and 1.7e-2 chunked (the port's flash plain version
  rounds P to bf16 before P V, as its tensor-core kernel does; JAX's
  chunked scan keeps P in f32).
* ``Model.decode_step``, step by step over 12 tokens: logits and caches,
  float32, within 1e-5.
* the serve launcher's loop (``launch.serve.run_request``): its greedy
  tokens equal the JAX decode loop's, float32, from the same prompt.
* a port of ``tests/test_models.py::test_prefill_decode_consistency`` with
  its bound.
* the launcher itself on the CPU, its refusals, and that nothing under
  ``src/repro_torch/`` (nor ``chip_smoke.py``) imports JAX or ``repro``.
"""
import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_1_7b as jqwen
from repro.models.transformer import Model as JModel
from repro.obs.timers import percentile as jpercentile
from repro_torch.configs import qwen3_1_7b as tqwen
from repro_torch.configs.base import ChocoConfig
from repro_torch.convert import (caches_from_jax, caches_to_jax,
                                 model_params_from_jax)
from repro_torch.kernels import dispatch
from repro_torch.launch import serve
from repro_torch.models.transformer import Model
from repro_torch.obs.timers import percentile
from repro_torch.optim.sgd import cosine_schedule, momentum_sgd
from repro_torch.train.trainer import DecentralizedTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 64
RTOL = {"float32": 1e-5, "bfloat16": 3e-2}


@functools.lru_cache(maxsize=None)
def _jax_params():
    return JModel(jqwen.SMOKE_CONFIG).init(jax.random.PRNGKey(0))


def _models(dtype="float32", attn_impl="naive"):
    kw = dict(dtype=dtype, attn_impl=attn_impl)
    jmodel = JModel(dataclasses.replace(jqwen.SMOKE_CONFIG, **kw))
    model = Model(dataclasses.replace(tqwen.SMOKE_CONFIG, **kw))
    jparams = _jax_params()
    params = model.compute_params(
        model_params_from_jax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, model, params


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _assert_caches(got, jcaches, rtol):
    want = caches_from_jax(jax.tree.map(np.asarray, jcaches))
    assert sorted(got) == sorted(want) == ["stack/c0/k", "stack/c0/v"]
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert _rel(got[name], want[name]) < rtol, name


@pytest.mark.parametrize("attn_impl", ["naive", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype, attn_impl):
    jmodel, jparams, model, params = _models(dtype, attn_impl)
    toks = _tokens(0, (B, S), jmodel.cfg.vocab_size)
    jlogits, jcaches = jax.jit(jmodel.prefill)(jparams,
                                               {"tokens": jnp.asarray(toks)})
    dispatch.reset_launch_counts()
    logits, caches = model.prefill(params, torch.from_numpy(toks)[None].long())
    assert set(dispatch.launch_counts().values()) == {0}   # CPU: plain only
    assert logits.shape == (1, B, 1, jmodel.cfg.vocab_size)
    assert _rel(logits[0], jlogits) < RTOL[dtype]
    cfg = model.cfg
    assert caches["stack/c0/k"].shape == (1, cfg.n_layers, B, S,
                                          cfg.n_kv_heads, cfg.resolved_head_dim)
    _assert_caches(caches, jcaches, RTOL[dtype])


def test_decode_steps_match_jax():
    jmodel, jparams, model, params = _models()
    steps = 12
    toks = _tokens(1, (B, steps), jmodel.cfg.vocab_size)
    jcache = jmodel.init_cache(B, steps)
    cache = model.init_cache(B, steps, "cpu")
    zeros = caches_from_jax(jax.tree.map(np.asarray, jcache))
    assert sorted(cache) == sorted(zeros)
    for name in zeros:
        assert cache[name].shape == zeros[name].shape
        assert cache[name].dtype == zeros[name].dtype
        assert not cache[name].any() and not zeros[name].any()
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(steps):
        jlogits, jcache = jdecode(jparams, jnp.asarray(toks[:, t:t + 1]),
                                  jcache, jnp.full((B,), t, jnp.int32))
        logits, cache = model.decode_step(
            params, torch.from_numpy(toks[None, :, t:t + 1]).long(), cache,
            torch.full((B,), t, dtype=torch.long))
        assert _rel(logits[0], jlogits) < RTOL["float32"], t
        _assert_caches(cache, jcache, RTOL["float32"])


def test_cache_conversion_round_trips():
    jmodel, jparams, model, params = _models("bfloat16")
    toks = _tokens(2, (B, 16), jmodel.cfg.vocab_size)
    _, jcaches = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    caches = caches_from_jax(jax.tree.map(np.asarray, jcaches))
    assert caches["stack/c0/k"].dtype == torch.bfloat16
    back = caches_to_jax(caches)
    for name in ("k", "v"):
        want = np.asarray(jcaches["stack"]["c0"][name], np.float32)
        np.testing.assert_array_equal(back["stack"]["c0"][name], want)
    with pytest.raises(ValueError, match="n = 1"):
        caches_to_jax({k: torch.cat([v, v]) for k, v in caches.items()})


def _jax_serve_loop(jmodel, jparams, prompt, gen_len):
    """The loop of ``src/repro/launch/serve.py`` on an injected prompt."""
    b, p = prompt.shape
    max_seq = p + gen_len
    cache = jmodel.init_cache(b, max_seq)
    decode = jax.jit(jmodel.decode_step)
    tok, out = prompt[:, :1], []
    for t in range(max_seq - 1):
        logits, cache = decode(jparams, tok, cache, jnp.full((b,), t, jnp.int32))
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        tok = prompt[:, t + 1:t + 2] if t + 1 < p else nxt
        if t + 1 >= p:
            out.append(nxt)
    return np.concatenate([np.asarray(o) for o in out], axis=1)


def test_serve_loop_tokens_match_jax():
    jmodel, jparams, model, params = _models()
    prompt = _tokens(3, (B, 8), jmodel.cfg.vocab_size)
    want = _jax_serve_loop(jmodel, jparams, jnp.asarray(prompt), 8)
    got, ttft, times = serve.run_request(
        model, params, torch.from_numpy(prompt).long(), 8, lambda: None)
    assert got.shape == (B, 8) and len(times) == 7 and ttft > 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("attn_impl", ["naive", "chunked"])
def test_prefill_decode_consistency(attn_impl):
    """Token-by-token decode reproduces the full-sequence last-token logits
    (the JAX test's bound, on the bf16 smoke model)."""
    cfg = dataclasses.replace(tqwen.SMOKE_CONFIG, attn_impl=attn_impl)
    model = Model(cfg)
    params = model.compute_params(model.init(1, 0, "cpu"))
    s = 12
    toks = torch.from_numpy(_tokens(4, (1, B, s), cfg.vocab_size)).long()
    logits_pre, _ = model.prefill(params, toks)
    assert logits_pre.shape == (1, B, 1, cfg.vocab_size)
    cache = model.init_cache(B, s, "cpu")
    for t in range(s):
        lg, cache = model.decode_step(params, toks[:, :, t:t + 1], cache,
                                      torch.full((B,), t, dtype=torch.long))
    a, b = lg.float().numpy(), logits_pre.float().numpy()
    assert np.max(np.abs(a - b)) / max(np.abs(b).max(), 1.0) < 0.05


def test_percentile_matches_jax():
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 100):
        vals = rng.random(n).tolist()
        for p in (0, 50, 99, 100):
            assert percentile(vals, p) == jpercentile(vals, p)
    with pytest.raises(ValueError):
        percentile([], 50)


# -- launcher -------------------------------------------------------------------

_SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--batch", "2", "--prompt-len",
          "4", "--gen-len", "3"]


def test_serve_launcher_runs_on_cpu_when_asked(capsys):
    assert serve.main(_SMOKE + ["--requests", "2", "--device", "cpu"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[serve] ")]
    assert lines[0].startswith("[serve] throughput_tok_s ")
    assert "ttft_p50_s" in lines[0] and "tok_p99_s" in lines[0]
    assert "decoded 6x2 tokens" in lines[1]
    summary = json.loads(lines[-1][len("[serve] summary "):])
    assert summary["serve/ttft_p50_s"] <= summary["serve/ttft_p99_s"]
    assert summary["serve/throughput_tok_s"] > 0


def test_serve_launcher_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(_SMOKE)


@pytest.mark.parametrize("extra,message", [
    (["--mesh", "1x1"], "--mesh is not supported"),
    (["--simulate-devices", "8"], "--simulate-devices is not supported"),
    (["--kv-layout", "seq"], "--kv-layout seq is not supported"),
    (["--metrics-dir", "m"], "--metrics-dir is not supported"),
    (["--arch", "mamba-2.8b"], "--arch 'mamba-2.8b' is not ported"),
    (["--requests", "0"], "--requests must be >= 1"),
])
def test_serve_launcher_refuses_flags_outside_the_slice(extra, message, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(_SMOKE + extra + ["--device", "cpu"])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b"])
def test_serve_launcher_serves_the_recurrent_families_on_cpu(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "4",
            "--gen-len", "3"]
    assert serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke " in out and "decoded 3x2 tokens" in out
    summary = json.loads([l for l in out.splitlines()
                          if l.startswith("[serve] summary ")][0][16:])
    assert summary["serve/throughput_tok_s"] > 0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b"])
def test_recurrent_serving_raises_without_cuda_unless_cpu_is_asked(
        arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", arch, "--smoke"])


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b"])
def test_train_launcher_refuses_the_recurrent_families(arch, capsys):
    from repro_torch.launch import train as train_launcher
    with pytest.raises(SystemExit) as exc:
        train_launcher.main(["--arch", arch, "--smoke", "--mesh", "4x1",
                             "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "training the SSM and hybrid families is not ported" in err
    assert "ROADMAP §1.5" in err and "it is served only" in err


def test_serve_launcher_refuses_before_importing_torch():
    code = ("import sys; from repro_torch.launch.serve import main\n"
            "try:\n    main(['--arch', 'qwen3-1.7b', '--kv-layout', 'seq'])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 2 and 'torch' not in sys.modules\n"
            "    print('refused')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "refused" in r.stdout, r.stderr


def test_trainer_refuses_chunked_attention():
    cfg = dataclasses.replace(tqwen.SMOKE_CONFIG, attn_impl="chunked")
    with pytest.raises(ValueError, match="no backward"):
        DecentralizedTrainer(model=Model(cfg), choco=ChocoConfig(), n_nodes=2,
                             optimizer=momentum_sgd(),
                             lr_fn=cosine_schedule(0.1, 1, 3), device="cpu")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = [(os.path.relpath(f, ROOT), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
