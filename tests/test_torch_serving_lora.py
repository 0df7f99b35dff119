"""The port's per-request LoRA experts in serving against procyon_tpu's on
the same bridged weights (f32 on the CPU, greedy): tokens equal request by
request and equal to each request's solo run, and a prefix cache that
keeps experts apart. Builders: tests/torch_serving_common.py."""

import numpy as np
import pytest

from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_serving_common import (
    make_lora_model, make_prompts, run_both, LORA_MODES)


@pytest.fixture(scope="module")
def lora_model():
    return make_lora_model()


@pytest.mark.parametrize("mode", sorted(LORA_MODES))
def test_lora_experts_equal_reference(lora_model, mode):
    pool, kw, lengths, experts = LORA_MODES[mode]
    rng = np.random.default_rng(71)
    reqs = [(p, 5, dict(lora_expert=e))
            for p, e in zip(make_prompts(rng, lengths), experts)]
    out, _, _ = run_both(lora_model, reqs, pool=pool, **kw)
    # each request equals its solo run under its own expert
    for (p, m, rkw), got in zip(reqs, out):
        _, tb = lora_model.batchers(pool=pool)
        rid = tb.submit(p, max_new=m, **rkw)
        assert tb.run()[rid] == got


def test_lora_prefix_cache_isolates_experts(lora_model):
    prompt = make_prompts(np.random.default_rng(83), [13])[0]
    reqs = [(prompt, 6, dict(lora_expert=e)) for e in (1, 2, 1)]
    out, _, tb = run_both(lora_model, reqs, pool=dict(slots=1, n_pages=48),
                           prefix_cache=True)
    assert out[0] == out[2]
    # only the same-expert repeat may hit the cached chain
    assert tb.pcache.stats["hit_tokens"] == 12
