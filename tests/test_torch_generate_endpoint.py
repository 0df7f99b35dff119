"""POST /generate of the port's stdlib server: concurrent HTTP clients
through one ContinuousBatcher (GenerationService's batcher thread) get the
tokens each prompt gets alone, which are procyon_tpu's; 503 without a
generation service; 400 and 422 as the reference answers them."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.inference import kv_pool as jkv
from procyon_tpu.inference.serving import ContinuousBatcher as JBatcher
from procyon_tpu.models import llama as jllama
from procyon_tpu_torch import bridge
from procyon_tpu_torch.app import server
from procyon_tpu_torch.inference import kv_pool as tkv
from procyon_tpu_torch.inference.serving import ContinuousBatcher
from procyon_tpu_torch.models import llama as tllama

POOL = dict(page_size=4, n_pages=64, max_pages_per_seq=12, slots=3)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.tiny_config(attn_backend="ref", remat=False)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.float32
    return jcfg, params, tllama.LlamaConfig(**fields), \
        bridge.to_torch(params)


def _batcher(tcfg, tparams, **kw):
    pcfg = tkv.PagedConfig(n_layers=tcfg.n_layers,
                           n_kv_heads=tcfg.n_kv_heads,
                           head_dim=tcfg.head_dim, dtype=torch.float32,
                           **POOL)
    return ContinuousBatcher(tparams, tcfg, pcfg, device="cpu", **kw)


def _post(port, payload, raw=None):
    body = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("kw", [{}, dict(step_quantum=2, async_rounds=True)],
                         ids=["sync", "async"])
def test_concurrent_http_generate_equals_solo(model, kw):
    jcfg, params, tcfg, tparams = model
    rng = np.random.default_rng(31)
    prompts = [list(map(int, rng.integers(4, jcfg.vocab_size, n)))
               for n in (5, 9, 4, 7)]
    lens = [6, 4, 8, 5]
    solo = []
    for p, m in zip(prompts, lens):             # the reference's, alone
        jp = jkv.PagedConfig(n_layers=jcfg.n_layers,
                             n_kv_heads=jcfg.n_kv_heads,
                             head_dim=jcfg.head_dim, dtype=jnp.float32,
                             **POOL)
        b = JBatcher(params, jcfg, jp)
        rid = b.submit(p, max_new=m)
        solo.append(b.run()[rid])
        tb = _batcher(tcfg, tparams)            # and the port's, alone
        rid = tb.submit(p, max_new=m)
        assert tb.run()[rid] == solo[-1]

    gen = server.GenerationService(_batcher(tcfg, tparams, **kw))
    httpd = server.serve(None, port=0, gen=gen, host="127.0.0.1",
                         background=True)
    port = httpd.server_address[1]
    try:
        results = [None] * len(prompts)

        def post(i):
            results[i] = _post(port, {"tokens": prompts[i],
                                      "max_new": lens[i]})

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [r[0] for r in results] == [200] * 4
        assert [r[1]["tokens"] for r in results] == solo
        # eos_id travels too
        code, body = _post(port, {"tokens": prompts[0], "max_new": 6,
                                  "eos_id": solo[0][2]})
        assert code == 200 and body["tokens"] == solo[0][:3]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert json.loads(r.read())["ok"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_generate_errors(model):
    _, _, tcfg, tparams = model
    gen = server.GenerationService(_batcher(tcfg, tparams))
    httpd = server.serve(None, port=0, gen=gen, host="127.0.0.1",
                         background=True)
    port = httpd.server_address[1]
    try:
        assert _post(port, None, raw=b"{not json")[0] == 400
        assert _post(port, [1, 2])[0] == 400
        for bad in ({}, {"tokens": []}, {"tokens": "abc"},
                    {"tokens": [1, "x"]}, {"tokens": [1], "max_new": "many"}):
            code, body = _post(port, bad)
            assert code == 422 and "error" in body, bad
        # a request the pool cannot hold surfaces as a 500, not a hang
        code, body = _post(port, {"tokens": list(range(4, 40)),
                                  "max_new": 30})
        assert code == 500 and "max_ctx" in body["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_generate_503_without_a_generation_service():
    httpd = server.serve(None, port=0, host="127.0.0.1", background=True)
    port = httpd.server_address[1]
    try:
        code, body = _post(port, {"tokens": [1, 2, 3]})
        assert code == 503 and "generation service" in body["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
