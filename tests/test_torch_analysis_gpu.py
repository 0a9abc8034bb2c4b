"""The port's analysis gate on the card: the live ptxas report against the
committed record, the ``sync`` pass over the 13 entry points, and the
sync-debug mode restored after it.  Needs a CUDA card and nvcc, no JAX;
every test here is marked ``gpu`` and skips without a card.  Run on a
card machine with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_analysis_gpu.py
"""
import json

import pytest
import torch

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import capture_audit as ca
from repro_torch.analysis import kernel_budget as kb
from repro_torch.kernels import _build

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_the_live_ptxas_report_equals_the_committed_record(cuda):
    _build.library()
    tag = _build.source_tag()
    live_text = _build.ptxas_report_path(tag).read_text()
    rec_tag, record = kb.load_record()
    assert kb.record_tag(live_text) == rec_tag == tag
    live = kb.parse_ptxas(live_text)
    assert {n: (k.source, k.numbers()) for n, k in live.items()} == \
        {n: (k.source, k.numbers()) for n, k in record.items()}
    fs, checked, rows = kb.run_budget(live=True)
    assert not [f for f in fs if f.rule == "BUDGET-STALE"], fs
    assert sorted(checked) == sorted(record)


def test_the_sync_pass_counts_every_entry_point(cuda, tmp_path):
    before = torch.cuda.get_sync_debug_mode()
    rep = tmp_path / "rep.json"
    assert cli.main(["--passes", "sync", "--report", str(rep), "-q"]) == 0
    syncs = json.loads(rep.read_text())["syncs"]
    names = [ep.name for ep in ca.default_entry_points()]
    assert list(syncs) == names
    for name in names:
        row = syncs[name]
        assert isinstance(row["syncs"], int) and row["syncs"] >= 0
        assert sum(row["sites"].values()) == row["syncs"]
    for name in ("PageTable._apply", "VersionedIndex.update",
                 "apply_ops_mesh[rebalance]", "exhaustion_guard_traced"):
        assert syncs[name]["per_op"] == syncs[name]["syncs"] / \
            syncs[name]["ops"]
    # no update path makes a sync: the update kernel, and the in-place
    # rebalance passes through the rebalance kernel; nor does the dense
    # kernel search, nor the eager sharded search (K3/K4 on the card)
    for name in ("VersionedIndex.update", "PageTable._apply",
                 "apply_ops_mesh[rebalance]", "watermark_rebalance_traced",
                 "exhaustion_guard_traced",
                 "search_kernel_sharded[fg,plain]"):
        assert syncs[name]["syncs"] == 0, name
    assert syncs["search_mesh[eager]"]["syncs"] <= 1
    assert torch.cuda.get_sync_debug_mode() == before


def test_count_syncs_records_the_site_and_restores_the_mode(cuda):
    x = torch.arange(16, device="cuda")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with ca.count_syncs() as sites:
            x.sum().item()
            int(x.max())
            y = x + 1                       # no sync
        assert len(sites) == 2 and y.is_cuda
        assert all(s[0].endswith("test_torch_analysis_gpu.py")
                   for s in sites)
        assert torch.cuda.get_sync_debug_mode() == 1
        with pytest.raises(ZeroDivisionError):
            with ca.count_syncs():
                1 / 0
        assert torch.cuda.get_sync_debug_mode() == 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with ca.count_syncs() as sites:
        x.cpu()
    assert len(sites) == 1 and torch.cuda.get_sync_debug_mode() == 0


def test_print_record_gives_a_record_of_todays_build(cuda):
    text = kb.live_record_text()
    assert kb.record_tag(text) == _build.source_tag()
    line = [ln for ln in text.splitlines()
            if ln.startswith("# built on the card machine: ")]
    assert len(line) == 1 and torch.cuda.get_device_name(0) in line[0]
    assert {n: k.numbers() for n, k in kb.parse_ptxas(text).items()} == \
        {n: k.numbers() for n, k in kb.load_record()[1].items()}
