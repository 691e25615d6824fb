"""The port's main-path CLIs (cli.common, cli.convert, cli.generate,
cli.serve) against aqlm_tpu's on the CPU.

One canonical checkpoint (a tiny Llama in 2x8 codes, f32, random weights
from JAX) is written by the JAX package once per module. Stated
tolerances: converted checkpoints byte-identical to JAX's convert of the
same input; greedy tokens identical to JAX's Engine; served logprobs within
1e-4 of JAX's server's. Every HTTP request has a timeout of its own.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aqlm_tpu.cli import convert as jcli_convert
from aqlm_tpu.cli import generate as jcli_generate
from aqlm_tpu.cli import serve as jcli_serve
from aqlm_tpu.cli.common import resolve_model as j_resolve_model
from aqlm_tpu.config import SCHEME_2X8
from aqlm_tpu.io import load_quantized_model as j_load
from aqlm_tpu.io import save_quantized_model as j_save
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models.quantize import random_quantized_params as j_random_quantized_params
from aqlm_tpu.serve import Engine as JEngine
from aqlm_tpu.serve import SamplingParams as JSampling
from aqlm_tpu.serve import ServeConfig as JServe
from aqlm_tpu_torch.cli import common, convert, generate, serve
from aqlm_tpu_torch.ops.runtime import QuantizedLinear

CFG = dict(num_layers=2, hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=4)
TIMEOUT = 120  # seconds, per HTTP request


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    path = str(root / "canonical")
    jcfg = jllama.ModelConfig.tiny(**CFG)
    jp = j_random_quantized_params(jax.random.PRNGKey(0), jcfg, SCHEME_2X8, mode="reference",
                                   dtype=jnp.float32)
    j_save(path, jp, jcfg)
    return path


@pytest.fixture(scope="module")
def int8_ckpt(ckpt, tmp_path_factory):
    """The canonical checkpoint materialized in int8 by JAX's convert."""
    path = str(tmp_path_factory.mktemp("cli_int8") / "int8")
    jcli_convert.main([ckpt, path, "--to", "int8"])
    return path


def _npz_arrays(path):
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".npz"):
            with np.load(os.path.join(path, name)) as data:
                for k in data.files:
                    out[f"{name}/{k}"] = data[k]
    return out


@pytest.mark.parametrize("to", ["canonical", "int8", "int4", "codes"])
def test_convert_writes_jax_identical_arrays(ckpt, tmp_path, to):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcli_convert.main([ckpt, jdir, "--to", to])
    convert.main([ckpt, pdir, "--to", to, "--device", "cpu"])
    want, got = _npz_arrays(jdir), _npz_arrays(pdir)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k.endswith("__meta__"):
            assert json.loads(str(got[k])) == json.loads(str(want[k])), k
        else:
            assert got[k].tobytes() == want[k].tobytes(), k
    with open(os.path.join(pdir, "config.json")) as f, open(os.path.join(jdir, "config.json")) as g:
        assert json.load(f) == json.load(g)
    jp, jcfg = j_load(pdir)  # aqlm_tpu reads the port's output
    assert jcfg == jllama.ModelConfig.tiny(**CFG) and len(jp["layers"]) == 2
    if to != "canonical":
        assert jp["layers"][0]["q_proj"].mode == to


def test_resolve_model_on_materialized_checkpoints(ckpt, int8_ckpt):
    params, cfg, kind = common.resolve_model(int8_ckpt, mode="int8", device="cpu")
    q = params["layers"][1]["down_proj"]
    assert kind == "quantized" and q.mode == "int8" and q.w8 is not None
    jp, _, _ = j_resolve_model(int8_ckpt, mode="int8")
    assert np.asarray(jp["layers"][1]["down_proj"].w8).tobytes() == q.w8.numpy().tobytes()
    for mode in ("codes", "reference", "int4"):
        with pytest.raises(ValueError) as got:
            common.resolve_model(int8_ckpt, mode=mode, device="cpu")
        with pytest.raises(ValueError) as want:
            j_resolve_model(int8_ckpt, mode=mode)
        assert str(got.value) == str(want.value)
    # the canonical checkpoint transcodes at load
    params, _, kind = common.resolve_model(ckpt, mode="int4", device="cpu")
    assert kind == "quantized" and all(
        v.mode == "int4" for layer in params["layers"] for v in layer.values()
        if isinstance(v, QuantizedLinear))
    params, cfg, kind = common.resolve_model("random:tiny:1", device="cpu")
    assert kind == "dense" and cfg.num_layers == 1


def test_load_tokenizer_is_none_without_one(ckpt):
    assert common.load_tokenizer(ckpt) is None
    assert common.load_tokenizer("random:tiny") is None
    assert common.load_tokenizer(os.path.join(ckpt, "missing")) is None


def _local_tokenizer(path):
    """A word-level tokenizer over 'w0'..'w255' (ids 0..255), built here
    and saved beside the model; no download."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {f"w{i}": i for i in range(256)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="w0"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="w0")
    fast.save_pretrained(path)


def _jax_tokens(path, mode, prompts, max_new, **serve_kw):
    jp, jcfg, _ = j_resolve_model(path, mode=mode)
    engine = JEngine(jp, jcfg, JServe(**serve_kw))
    out = engine.generate([np.asarray(p, np.int32) for p in prompts],
                          JSampling(max_new_tokens=max_new))
    return [[int(t) for t in o] for o in out]


@pytest.mark.parametrize("mode", ["codes", "int8"])
def test_generate_cli_matches_jax(ckpt, mode, capsys):
    prompt = "5,17,200,3,9,64,1,2,250,7"
    common_args = [ckpt, "--mode", mode, "--prompt", prompt, "--max_new_tokens", "6",
                   "--max_len", "64", "--benchmark"]
    jcli_generate.main(common_args + ["--no_compile_cache"])
    jout = capsys.readouterr().out.strip().splitlines()
    got = generate.main(common_args + ["--device", "cpu", "--no_compile_cache"])
    out = capsys.readouterr().out.strip().splitlines()
    last, jlast = json.loads(out[-1]), json.loads(jout[-1])
    assert set(last) == set(jlast) == {"tokens_per_second", "new_tokens"}
    assert last["new_tokens"] == jlast["new_tokens"]
    assert out[0].startswith("<") and out[0].endswith(" tokens per second>")
    assert len(out) == len(jout) == 2
    ids = [int(t) for t in prompt.split(",")]
    want = _jax_tokens(ckpt, mode, [ids], 6, max_batch=1, max_len=64, prefill_buckets=(32, 64))
    assert got["tokens"] == want[0] and len(got["tokens"]) == 6


def test_generate_cli_text_prompt_with_a_local_tokenizer(ckpt, tmp_path, capsys):
    model = str(tmp_path / "with_tokenizer")
    convert.main([ckpt, model, "--to", "codes", "--device", "cpu"])
    _local_tokenizer(model)
    tok = common.load_tokenizer(model)
    assert tok is not None and tok("w5 w17 w200").input_ids == [5, 17, 200]
    capsys.readouterr()
    got = generate.main([model, "--mode", "codes", "--prompt", "w5 w17 w200 w3",
                         "--max_new_tokens", "4", "--max_len", "64", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"tokens_per_second", "new_tokens", "text"}
    assert last["text"] == tok.decode(got["tokens"])
    want = _jax_tokens(ckpt, "codes", [[5, 17, 200, 3]], 4, max_batch=1, max_len=64,
                       prefill_buckets=(32, 64))
    assert got["tokens"] == want[0]


def _post(port, path, body, stream=False):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        if not stream:
            return json.loads(r.read())
        chunks = []
        for line in r.read().decode().split("\n\n"):
            if line.startswith("data: ") and line != "data: [DONE]":
                chunks.append(json.loads(line[len("data: "):]))
        assert line == "" or line.endswith("[DONE]")
        return chunks


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
        return json.loads(r.read())


PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [4, 4, 4, 4], [100, 50, 25, 12, 6, 3], [9, 9]]
REQUESTS = [("/generate", dict(max_new_tokens=5), False),
            ("/v1/completions", dict(max_tokens=5), False),
            ("/v1/completions", dict(max_tokens=5, logprobs=1), False),
            ("/v1/completions", dict(max_tokens=5, stream=True), True),
            ("/generate", dict(max_new_tokens=5), False)]


def _serve_all(port):
    """Every request of REQUESTS at once, each from its own thread."""
    results = {}

    def client(i):
        path, extra, stream = REQUESTS[i]
        results[i] = _post(port, path, {"prompt_ids": PROMPTS[i], **extra}, stream)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(REQUESTS))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(TIMEOUT)
    assert sorted(results) == list(range(len(REQUESTS)))
    return results


def _start(httpd):
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd.server_address[1]


@pytest.mark.parametrize("decode_chunk", [1, 3])
def test_serve_matches_jax_server(int8_ckpt, decode_chunk):
    """Concurrent /generate and /v1/completions (one with logprobs, one SSE)
    on the port's server and on JAX's, both over int8 engines: the same
    response keys, greedy tokens equal to JAX's Engine, logprobs within 1e-4."""
    argv = [int8_ckpt, "--port", "0", "--max_batch", "2", "--max_len", "64",
            "--prefill_buckets", "8", "16", "--mode", "int8", "--kv_int8",
            "--decode_chunk", str(decode_chunk), "--device", "cpu"]
    httpd, server = serve.make_server(serve.build_parser().parse_args(argv))
    jp, jcfg, _ = j_resolve_model(int8_ckpt, mode="int8")
    jserver = jcli_serve._Server(JEngine(jp, jcfg, JServe(
        max_batch=2, max_len=64, prefill_buckets=(8, 16), kv_quantized=True,
        decode_chunk=decode_chunk)), None, model_id="int8")
    jhttpd = jcli_serve.ThreadingHTTPServer(("127.0.0.1", 0), jcli_serve.make_handler(jserver))
    port, jport = _start(httpd), _start(jhttpd)
    try:
        assert _get(port, "/health") == _get(jport, "/health") == {"status": "ok"}
        assert _get(port, "/v1/models") == _get(jport, "/v1/models")
        got, want = _serve_all(port), _serve_all(jport)
    finally:
        for h, s in ((httpd, server), (jhttpd, jserver)):
            h.shutdown()
            h.server_close()
            s.stop()
    expect = _jax_tokens(int8_ckpt, "int8", PROMPTS, 5, max_batch=2, max_len=64,
                         prefill_buckets=(8, 16), kv_quantized=True, decode_chunk=decode_chunk)
    for i, (path, extra, stream) in enumerate(REQUESTS):
        g, w = got[i], want[i]
        if stream:
            assert len(g) == len(w) == 5
            assert [sorted(c) for c in g] == [sorted(c) for c in w]
            assert [c["choices"][0]["token_ids"][0] for c in g] == expect[i]
            continue
        assert sorted(g) == sorted(w)
        if path == "/generate":
            assert g["tokens"] == expect[i]
            continue
        gc, wc = g["choices"][0], w["choices"][0]
        assert sorted(gc) == sorted(wc) and gc["token_ids"] == expect[i]
        assert {k: v for k, v in g.items() if k != "choices"} == \
            {k: v for k, v in w.items() if k != "choices"}
        if extra.get("logprobs"):
            np.testing.assert_allclose(gc["logprobs"]["token_logprobs"],
                                       wc["logprobs"]["token_logprobs"], atol=1e-4)


def test_serve_reports_bad_requests_and_unknown_paths(int8_ckpt):
    argv = [int8_ckpt, "--port", "0", "--max_batch", "1", "--max_len", "32",
            "--prefill_buckets", "8", "--device", "cpu"]
    httpd, server = serve.make_server(serve.build_parser().parse_args(argv))
    port = _start(httpd)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:  # text without a tokenizer
            _post(port, "/generate", {"prompt": "hello"})
        assert e.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as e:  # no decode room at max_len 32
            _post(port, "/generate", {"prompt_ids": list(range(40))})
        assert e.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nowhere")
        assert e.value.code == 404
        assert _post(port, "/generate", {"prompt_ids": [1, 2], "max_new_tokens": 2})["tokens"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()


UNPORTED = [
    (convert, ["--to", "hf"], "A10"),
    (convert, ["--to", "int8", "--from_format", "legacy"], "A10"),
    (convert, ["--to", "int8", "--from_format", "legacy_fsdp"], "A10"),
    (serve, ["--tp", "2"], "A14"), (serve, ["--tp", "2", "--draft_model", "random:tiny"], "A14"),
]


@pytest.mark.parametrize("module,flags,item", UNPORTED,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}{' '.join(f)}" for m, f, _ in UNPORTED])
def test_unported_flags_raise_their_item(ckpt, tmp_path, module, flags, item):
    if module is convert:
        argv = [ckpt, str(tmp_path / "out"), *flags, "--device", "cpu"]
    else:
        argv = [ckpt, *flags, "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=item):
        if module is serve:
            module.make_server(module.build_parser().parse_args(argv))
        else:
            module.main(argv)
