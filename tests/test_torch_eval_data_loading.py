"""procyon_tpu_torch's evaluate/data_loading.py against procyon_tpu's on
the CPU: load_datasets_for_eval on the fabricated DATA_DIR of
tests/test_eval_realdata.py gives the JAX entries, each bound to a
TextTableStore. The fixture needs pandas (skipped without it, as there);
the rest of the evaluation tests do not.
"""

import os

import pytest

pytest.importorskip("pandas")

from procyon_tpu.data import datasets as jD  # noqa: E402
from procyon_tpu.evaluate.data_loading import \
    load_datasets_for_eval as jload_datasets  # noqa: E402
from procyon_tpu_torch.data import datasets as tD  # noqa: E402
from procyon_tpu_torch.evaluate.data_loading import \
    load_datasets_for_eval as tload_datasets  # noqa: E402
from test_eval_realdata import data_dir  # noqa: E402,F401


def _entry_view(entry):
    return {k: v for k, v in entry.items() if k != "store"}


@pytest.mark.parametrize("tasks", [["retrieval", "qa", "caption"],
                                   ["qa"]])
def test_load_datasets_for_eval_matches_reference(data_dir, tasks):  # noqa: F811
    emb = os.path.join(data_dir, "generated_data", "aaseq_embeddings",
                       "protein_embeds.npy")
    spec = [{"text_type": "go", "relation": "process", "tasks": tasks}]
    got = tload_datasets(data_dir, spec, store=tD.ProCyonDataStore(
        data_dir, embedding_file=emb))
    want = jload_datasets(data_dir, spec, store=jD.ProCyonDataStore(
        data_dir, embedding_file=emb))
    assert got.keys() == want.keys() == {f"go_process_{t}" for t in tasks}
    for name in want:
        assert _entry_view(got[name]) == _entry_view(want[name]), name
        ts, js = got[name]["store"], want[name]["store"]
        assert isinstance(ts, tD.TextTableStore)
        assert [ts.text(i) for i in range(4)] \
            == [js.text(i) for i in range(4)]
