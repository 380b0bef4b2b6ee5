"""The port's tracing, metrics and request-flow surface (``utils``) against
the JAX package's, on the CPU.

Each test of tests/test_trace_surface.py runs here through the port: the
workload goes through the port's ``uvm`` and its application span through
the port's ``utils.span``, and every assertion of the JAX test holds on the
port.  Both packages bind the one native engine, so what the engine
recorded is read through both surfaces, with the JAX function as the
reference: the event names of the export, the histogram quantiles, the
Prometheus families, the procfs listing, the SLO and flow readouts.  One
application span through each package must export the same event.  The
port's metrics inventory is this module's ``METRICS_INVENTORY``: the JAX
test's names and the counters only the port registers
(``PORT_ONLY_COUNTERS``); the native ``check-metrics`` lint runs over the
port's Python tree against it.
"""

import json
import os
import re
import subprocess

import pytest

from open_gpu_kernel_modules_tpu import utils as jutils
from open_gpu_kernel_modules_tpu.uvm import journal as jjournal
from open_gpu_kernel_modules_tpu_torch import utils, uvm
from open_gpu_kernel_modules_tpu_torch.uvm import ce as _ce
from open_gpu_kernel_modules_tpu_torch.uvm import journal

import test_trace_surface as jax_surface
from test_trace_surface import _parse_prometheus

MB = 1 << 20

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "open_gpu_kernel_modules_tpu_torch")
JAX_PKG = os.path.join(REPO, "open_gpu_kernel_modules_tpu")

#: Python counters the port registers and the JAX package does not: the
#: tier's read and flush accounting (``models/serving.py``), which the
#: port keeps itself (``utils.port_counter_add``) and its benchmark reads.
PORT_ONLY_COUNTERS = {"tputier_read_bytes", "tputier_read_ns",
                      "tputier_flush_bytes", "tputier_flush_ns"}

#: Every counter and exposition family the engine and the port register,
#: by name, as the JAX test's inventory counts them, with
#: ``PORT_ONLY_COUNTERS``.  Kept sorted and literal: the ``check-metrics``
#: lint reads it from this file.
METRICS_INVENTORY = [
    "broker_client_deaths", "broker_heartbeat_reaps",
    "broker_reclaimed_clients", "broker_reclaimed_fds",
    "broker_reclaimed_pin_bytes", "broker_reclaimed_pins",
    "broker_zombie_doorbells", "channel_bytes_copied",
    "channel_copies_completed", "channel_pushes", "channel_rc_resets",
    "cxl_buffers_registered", "cxl_buffers_unregistered", "cxl_dma_bytes",
    "cxl_dma_requests", "dmabuf_exports", "hbm_mirror_bytes",
    "hbm_mirror_overflows", "hbm_readback_requests", "hot_inject_skips",
    "ib_mr_invalidations", "ib_mr_registrations", "ici_degraded_routes",
    "ici_hop_bytes", "ici_link_flaps", "ici_links_trained",
    "ici_multihop_copies", "ici_peer_apertures", "ici_peer_copy_bytes",
    "ici_reset_retrains", "ici_retrain_failures", "ici_wire_crc_errors",
    "journal_dump_errors", "journal_dump_io_errors", "journal_dumps",
    "journal_log_mirrors", "memring_coalesced_sqes", "memring_cq_overflows",
    "memring_cqes", "memring_deadline_expired", "memring_dep_cancelled",
    "memring_dep_stalls", "memring_error_cqes", "memring_fences",
    "memring_fused_evictions", "memring_inject_error_cqes",
    "memring_inject_error_runs", "memring_inject_retries",
    "memring_internal_inline", "memring_internal_sqes",
    "memring_internal_submits", "memring_links_cancelled",
    "memring_ooo_retires", "memring_ops", "memring_park_timeouts",
    "memring_prod_contended", "memring_retries", "memring_rings_created",
    "memring_shard_sqes", "memring_sqes", "memring_sqpoll_polls",
    "memring_sqpoll_sleeps", "memring_stale_completions", "memring_steals",
    "memring_submits", "memring_tier_evict_runs", "peermem_dma_maps",
    "peermem_get_pages", "peermem_put_pages", "peermem_revocations",
    "pmm_chunk_allocs", "pmm_chunk_frees", "rc_auto_resets",
    "rc_device_escalations", "rc_nonreplayable_faults",
    "rc_shadow_overflows", "rc_watchdog_timeouts", "rdma_mrs_revalidated",
    "rdma_reset_revocations", "recover_copy_retries",
    "recover_fault_retries", "recover_link_retrains",
    "recover_msgq_retries", "recover_page_quarantines", "recover_rc_resets",
    "recover_rdma_retries", "recover_retries", "recover_tier_fallbacks",
    "rm_events_allocated", "rm_events_delivered", "rm_memory_maps",
    "shield_crc_selftest_fallbacks", "shield_crc_selftests",
    "shield_detected", "shield_inject_corrupts", "shield_inject_misses",
    "shield_retire_overflow", "shield_retired_realloc",
    "shield_wire_mismatches", "shield_wire_verifies",
    "tier_hot_victim_reorders", "tier_lock_contended",
    "tier_remote_demote_bytes", "tier_remote_demote_fails",
    "tier_remote_demotes", "tier_remote_fence_aborts",
    "tier_remote_headroom_refusals", "tier_remote_promote_bytes",
    "tier_remote_promotes", "tier_remote_revokes", "tier_tenant_binds",
    "tier_tenant_configs", "tier_tenant_evictions",
    "tier_tenant_over_quota_evictions", "tier_tenant_slo_reorders",
    "tpuce_compressed_bytes_in", "tpuce_compressed_bytes_out",
    "tpuce_compressed_bytes_raw", "tpuce_deadline_expired",
    "tpuce_dep_join_waits", "tpuce_inject_errors", "tpuce_inject_retries",
    "tpuce_lossless_fallbacks", "tpuce_ooo_completions", "tpuce_retries",
    "tpuce_stale_completions", "tpuce_stripe_errors", "tpuce_stripe_splits",
    "tpurm_counter", "tpurm_cpu_pins", "tpurm_device_generation",
    "tpurm_device_health", "tpurm_device_health_score", "tpurm_flow_drops",
    "tpurm_flow_drops_total", "tpurm_flow_unmatched_total",
    "tpurm_flows_closed", "tpurm_flows_closed_total", "tpurm_flows_open",
    "tpurm_flows_opened", "tpurm_health_transitions",
    "tpurm_hot_device_score", "tpurm_hot_pins", "tpurm_hot_prefetch_grown",
    "tpurm_hot_prefetch_shrunk", "tpurm_hot_thrash_pages",
    "tpurm_hot_throttle_delays", "tpurm_hot_throttles",
    "tpurm_journal_capacity", "tpurm_journal_dropped",
    "tpurm_journal_records", "tpurm_pages_retired", "tpurm_reset_failed",
    "tpurm_reset_injected", "tpurm_reset_mttr_ns", "tpurm_reset_total",
    "tpurm_scrub_hits", "tpurm_scrub_pages", "tpurm_scrub_ticks",
    "tpurm_shield_mismatches", "tpurm_shield_pages_poisoned",
    "tpurm_shield_pages_retired", "tpurm_shield_refetch_saves",
    "tpurm_shield_seals", "tpurm_shield_verifies", "tpurm_slo_blame_ns",
    "tpurm_tenant_pages", "tpurm_tenant_quota_pages",
    "tpurm_tenant_rebinds", "tpurm_tier_remote_pages",
    "tpurm_trace_dropped_total", "tpurm_trace_records_total",
    "tpurm_trace_rings", "tpurm_watchdog_device_resets",
    "tpurm_watchdog_evacuations", "tpurm_watchdog_nudges",
    "tpurm_watchdog_rc_resets", "tpusched_admit_retries",
    "tpusched_admit_sheds", "tpusched_admitted", "tpusched_cancelled",
    "tpusched_decoded_tokens", "tpusched_device_resets",
    "tpusched_evac_aborts", "tpusched_evacuations", "tpusched_evict_errors",
    "tpusched_fused_evict_chains", "tpusched_poisoned_retired",
    "tpusched_preempted", "tpusched_restored", "tpusched_retired",
    "tpusched_round_errors", "tpusched_rounds",
    "tpusched_seq_slots_retired", "tpusched_submitted",
    "tpusplit_pages_shipped", "tpusplit_reclaims", "tpusplit_ship_aborts",
    "tpusplit_ships", "tputier_flush_bytes", "tputier_flush_ns",
    "tputier_read_bytes", "tputier_read_ns", "uvm_access_counter_demotions",
    "uvm_access_counter_promotions", "uvm_accessed_by_mappings",
    "uvm_ats_accesses", "uvm_ats_bytes", "uvm_block_evictions",
    "uvm_bytes_xfer_dth", "uvm_bytes_xfer_htd", "uvm_compressible_advises",
    "uvm_cpu_fault_count", "uvm_device_wrote_invalidations",
    "uvm_external_maps", "uvm_fault_batches", "uvm_fault_cancels",
    "uvm_fault_drain_park_bails", "uvm_fault_flush_serviced",
    "uvm_first_touch_writes", "uvm_gpu_fault_count", "uvm_hmm_adoptions",
    "uvm_managed_bytes_allocated", "uvm_migrate_calls",
    "uvm_mmu_pte_batches", "uvm_mmu_tlb_invalidates", "uvm_mmu_tlb_pages",
    "uvm_prefetch_hits", "uvm_prefetch_pages", "uvm_prefetch_useless",
    "uvm_range_splits", "uvm_resumes", "uvm_suspends",
    "uvm_tools_events_dropped", "uvm_va_spaces_created",
    "uvm_write_faults_inferred", "vac_aborts", "vac_acks",
    "vac_bytes_moved", "vac_commit_ns", "vac_commit_rejected",
    "vac_commits", "vac_crc_mismatches", "vac_crc_reships",
    "vac_crc_verifies", "vac_failed_acks", "vac_grace_expired",
    "vac_inject_aborts", "vac_inject_retries", "vac_operator_requests",
    "vac_pages_moved", "vac_requests", "vac_txn_begins",
]


@pytest.fixture
def traced():
    """Armed tracing scoped to one test (rings cleared both ways)."""
    utils.trace_reset()
    utils.trace_start()
    yield
    utils.trace_stop()
    utils.trace_reset()


def _workload():
    """Managed alloc -> write (CPU faults) inside an application span ->
    device access (migration + channel pushes) -> free, through the port."""
    with uvm.VaSpace() as vs:
        buf = vs.alloc(2 * MB)
        with utils.span("app.phase.populate", nbytes=2 * MB):
            buf.view()[:] = 0x5C
        buf.device_access(dev=0, write=False)
        buf.free()


def _stable(read_jax, read_port, tries=5):
    """(port, jax) reads of a value background engine threads may move:
    the port's read must equal a JAX read taken just before or just after
    it."""
    for _ in range(tries):
        before = read_jax()
        got = read_port()
        after = read_jax()
        if got in (before, after):
            return got, got
    return got, after


def test_spans_and_chrome_trace_format(traced):
    _workload()
    utils.trace_stop()

    text = utils.trace_export_json()
    doc = json.loads(text)
    events = doc["traceEvents"]
    assert events, "no trace events for a full alloc/access/free cycle"
    for e in events:
        for key in ("ph", "ts", "pid", "tid", "name"):
            assert key in e, (key, e)
        assert e["ph"] in ("X", "i")
        if e["ph"] == "X":
            assert "dur" in e

    names = {e["name"] for e in events}
    for want in ("fault.wake", "fault.service", "fault.latency",
                 "migrate.copy", "channel.push", "channel.fence",
                 "msgq.publish", "pmm.alloc"):
        assert want in names, (want, sorted(names))
    # The same rings read through the JAX surface: the same events.
    assert {e["name"] for e in jutils.trace_export()["traceEvents"]} == names

    app = [e for e in events if e["name"] == "app.phase.populate"]
    assert len(app) == 1 and app[0]["ph"] == "X"
    assert app[0]["args"]["bytes"] == 2 * MB

    lats = [e for e in events if e["name"] == "fault.latency"]
    svcs = [e for e in events if e["name"] == "fault.service"]
    assert lats and svcs
    assert any(
        lat["ts"] <= svc["ts"] and
        svc["ts"] + svc["dur"] <= lat["ts"] + lat["dur"] + 1e3
        for lat in lats for svc in svcs)

    st = utils.trace_stats()
    assert st["recorded"] > 0 and st["rings"] >= 1
    assert st == jutils.trace_stats()


def test_disarmed_emits_nothing():
    utils.trace_stop()
    utils.trace_reset()
    _workload()
    assert utils.trace_stats()["recorded"] == 0
    doc = utils.trace_export()
    assert [e["name"] for e in doc["traceEvents"]] == ["tpurm.export"]
    assert [e["name"] for e in jutils.trace_export()["traceEvents"]] == \
        ["tpurm.export"]


def test_histograms_back_fault_stats(traced):
    uvm.fault_stats_reset_windows()
    _workload()
    st = uvm.fault_stats()
    assert st.service_ns_p50 > 0
    assert st.service_ns_p95 >= st.service_ns_p50
    p50 = utils.trace_quantile_ns("fault.latency", 0.50)
    p95 = utils.trace_quantile_ns("fault.latency", 0.95)
    assert p50 == st.service_ns_p50
    assert p95 == st.service_ns_p95
    assert utils.trace_hist_count("fault.latency") > 0
    utils.trace_stop()
    for site in ("fault.latency", "app.span", "migrate.copy"):
        assert utils.trace_hist_count(site) == \
            jutils.trace_hist_count(site), site
        assert utils.trace_quantile_ns(site, 0.5) == \
            jutils.trace_quantile_ns(site, 0.5), site


def test_prometheus_metrics_node(traced):
    _workload()
    text = utils.metrics_text()
    assert text, "metrics node rendered empty"
    types, samples = _parse_prometheus(text)
    assert types.get("tpurm_counter") == "counter"

    hist_families = [f for f, k in types.items() if k == "histogram"]
    assert "tpurm_fault_latency_ns" in hist_families
    for fam in hist_families:
        buckets = [(m, v) for (n, m, v) in samples
                   if n == fam + "_bucket"]
        count = [v for (n, m, v) in samples if n == fam + "_count"]
        assert buckets and len(count) == 1
        values = [v for _, v in buckets]
        assert values == sorted(values), fam
        inf = [v for m, v in buckets if 'le="+Inf"' in m]
        assert inf == [count[0]], fam

    names = {m for (_, m, _) in samples}
    assert any('name="channel_pushes"' in m for m in names)
    assert any('name="tpuce_ch0_bytes"' in m for m in names), \
        sorted(n for n in names if "tpuce" in n)
    assert any('name="tpuce_ch0_busy_ns"' in m for m in names)
    if _ce.channels() >= 2:
        assert any('name="tpuce_ch1_bytes"' in m for m in names)

    assert types.get("tpurm_journal_records") == "counter"
    assert types.get("tpurm_journal_dropped") == "counter"
    assert types.get("tpurm_journal_capacity") == "gauge"
    assert "driver/tpurm/metrics" in utils.procfs_list()

    inv = set(METRICS_INVENTORY)
    for fam in types:
        if fam in inv:
            continue
        assert re.fullmatch(r"tpurm_[a-z0-9_]+_ns", fam), \
            f"family {fam} not in METRICS_INVENTORY"
    for (_, metric, _) in samples:
        m = re.match(r'tpurm_counter\{name="([^"]+)"', metric)
        if not m:
            continue
        name = re.sub(r"\[[^\]]*\]$", "", m.group(1))
        assert name in inv or re.fullmatch(r"tpuce_ch\d+_(bytes|busy_ns)",
                                           name), \
            f"counter {name} not in METRICS_INVENTORY"

    # The JAX scrape of the same engine: the same families and types.
    jtypes, _ = _parse_prometheus(jutils.metrics_text())
    assert jtypes == types


# ------------------------------------------------------- check-metrics lint


def _check_metrics(py_dir, extra=None):
    env = dict(os.environ)
    if extra:
        env["CHECK_METRICS_EXTRA"] = extra
    return subprocess.run(
        ["sh", "scripts/check_metrics.sh", "src", py_dir,
         os.path.abspath(__file__)],
        cwd=os.path.join(REPO, "native"), env=env, capture_output=True,
        text=True, timeout=120)


def _python_counters(pkg_dir):
    """Counter names a package registers from Python (the lint's grep)."""
    pat = re.compile(r'(?:_counter_add|tpuCounterAdd)\(b?"([a-z_][a-z0-9_]*)"')
    names = set()
    for root, _, files in os.walk(pkg_dir):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names.update(pat.findall(fh.read()))
    return names


def test_check_metrics_lint_passes():
    """Every counter the port registers (native and Python) is in the
    inventory, and the port registers the JAX package's Python counters
    and its own ``PORT_ONLY_COUNTERS``, no more, no fewer."""
    proc = _check_metrics(PORT_PKG)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "check-metrics OK" in proc.stdout
    assert _python_counters(PORT_PKG) == \
        _python_counters(JAX_PKG) | PORT_ONLY_COUNTERS
    assert not PORT_ONLY_COUNTERS & _python_counters(JAX_PKG)


def test_port_inventory_is_jaxs_and_the_ports_own():
    """The port's inventory is the JAX test's with ``PORT_ONLY_COUNTERS``
    added, sorted, so the two stay one list apart."""
    assert METRICS_INVENTORY == sorted(METRICS_INVENTORY)
    assert set(METRICS_INVENTORY) == \
        set(jax_surface.METRICS_INVENTORY) | PORT_ONLY_COUNTERS
    assert not PORT_ONLY_COUNTERS & set(jax_surface.METRICS_INVENTORY)


def test_port_counters_in_exposition():
    """The port's own counters are samples of the ``tpurm_counter`` family
    in the port's exposition, read by ``counter``, and absent from the
    engine's registry and so from the JAX package's exposition."""
    name = "tputier_read_ns"
    utils.port_counter_add(name, 3)
    n = utils.counter(name)
    assert n >= 3
    types, samples = _parse_prometheus(utils.metrics_text())
    assert types["tpurm_counter"] == "counter"
    assert ("tpurm_counter", f'tpurm_counter{{name="{name}"}}',
            float(n)) in samples
    _, jsamples = _parse_prometheus(jutils.metrics_text())
    assert not [m for _, m, _ in jsamples if f'"{name}"' in m]
    assert jutils.counter(name) == 0


def test_check_metrics_lint_negative():
    proc = _check_metrics(PORT_PKG, "bogus_unasserted_counter_xyz")
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "bogus_unasserted_counter_xyz" in proc.stdout + proc.stderr


# -------------------------------------------------------- tpuflow surface


def test_flow_slo_series_in_scrape():
    utils.flow_reset()
    try:
        flow = utils.flow_mint(3, 77)
        assert flow == jutils.flow_mint(3, 77)
        utils.flow_open(flow)
        utils.flow_account(flow, "copy", 2_000_000)
        utils.flow_account(flow, "queued", 5_000_000)
        utils.flow_tokens(flow, 8)
        utils.slo_record(3, "ttft", 40_000_000)
        utils.slo_record(3, "itl", 3_000_000, count=8)
        utils.flow_close(flow)

        text = utils.metrics_text()
        types, samples = _parse_prometheus(text)
        assert types.get("tpurm_slo_ttft_ns") == "histogram"
        assert types.get("tpurm_slo_itl_ns") == "histogram"
        assert types.get("tpurm_slo_blame_ns") == "counter"
        names = {m for (_, m, _) in samples}
        assert 'tpurm_slo_itl_ns_count{tenant="3"}' in names
        assert any('tpurm_slo_blame_ns{tenant="3",bucket="copy"}' in m
                   for m in names)

        assert utils.slo_count(3, "itl") == 8
        p50 = utils.slo_quantile_ns(3, "itl", 0.5)
        assert 2_800_000 < p50 < 3_200_000
        assert p50 == jutils.slo_quantile_ns(3, "itl", 0.5)
        for b in utils.FLOW_BUCKETS:
            assert utils.slo_blame_ns(3, b) == jutils.slo_blame_ns(3, b)

        flows = utils.procfs_read("/proc/driver/tpurm/flows")
        assert "closed" in flows and "queued" in flows
        assert "driver/tpurm/flows" in utils.procfs_list()

        rep = utils.flow_report()
        assert rep and rep[0]["tenant"] == 3
        assert rep[0]["blame_ns"]["queued"] == 5_000_000
        assert rep[0]["tokens"] == 8
        assert rep[0]["state"] == "closed"
        assert rep == jutils.flow_report()
    finally:
        utils.flow_reset()


# ----------------------------------------------------- application spans


def _app_span(mod, name, obj, nbytes):
    """One application span through ``mod.span``; its exported event."""
    utils.trace_reset()
    utils.trace_start()
    try:
        with mod.span(name, obj=obj, nbytes=nbytes):
            pass
    finally:
        utils.trace_stop()
    events = [e for e in utils.trace_export()["traceEvents"]
              if e["name"] == name]
    count = utils.trace_hist_count("app.span")
    utils.trace_reset()
    return events, count


@pytest.mark.parametrize("name,obj,nbytes", [
    ("app.phase.populate", 0, 2 * MB),
    ("app.x", 0x5EED, 12345),
    ("tokenize", 7, 0),
])
def test_app_span_exports_as_jax(name, obj, nbytes):
    """``utils.span(name, obj=, nbytes=)`` takes any name and exports the
    JAX package's event: an "X" event of category app under that name, with
    the same args, counted in the app.span histogram."""
    got, n_port = _app_span(utils, name, obj, nbytes)
    want, n_jax = _app_span(jutils, name, obj, nbytes)
    assert len(got) == len(want) == 1
    assert n_port == n_jax == 1
    keys = ("name", "cat", "ph", "pid", "tid", "args")
    assert {k: got[0][k] for k in keys} == {k: want[0][k] for k in keys}
    assert got[0]["args"] == {"obj": hex(obj), "bytes": nbytes}


def test_site_spans_stay_on_their_sites(traced):
    """The Scheduler's and vac's private spans emit on registered engine
    sites (sched.* and vac.migrate), not as application spans."""
    from open_gpu_kernel_modules_tpu_torch.runtime import sched
    from open_gpu_kernel_modules_tpu_torch.uvm import vac
    with sched._span("sched.round", obj=4):
        pass
    with vac._span("vac.migrate", obj=(1 << 32) | 2, bytes_=4096):
        pass
    utils.trace_stop()
    events = {e["name"]: e for e in utils.trace_export()["traceEvents"]}
    assert events["sched.round"]["args"]["obj"] == "0x4"
    assert events["vac.migrate"]["args"]["bytes"] == 4096
    assert utils.trace_hist_count("sched.round") == 1
    assert utils.trace_hist_count("vac.migrate") == 1
    assert utils.trace_hist_count("app.span") == 0
    with pytest.raises(KeyError):
        sched._span("app.phase.populate")


# ------------------------------------------------------------- readers


def _export_events(text):
    """An export's events, the export's own time stamp (its moment of
    rendering) dropped."""
    events = json.loads(text)["traceEvents"]
    for e in events:
        if e["name"] == "tpurm.export":
            e.pop("ts")
    return events


def _engine_lines(text):
    """An exposition without the samples of the port's own counters
    (``PORT_ONLY_COUNTERS``), which the JAX package does not keep."""
    own = tuple(f'tpurm_counter{{name="{n}"}} ' for n in PORT_ONLY_COUNTERS)
    return [line for line in text.splitlines() if not line.startswith(own)]


def _readers(mod, jour, tmp):
    """Each text reader of ``utils`` and ``journal``, by name."""
    def saved():
        path = mod.trace_save(str(tmp / f"{mod.__name__}.json"))
        with open(path) as f:
            return _export_events(f.read())
    return {
        "journal_dump": mod.journal_dump,
        "procfs_read": lambda: mod.procfs_read("/proc/driver/tpurm/version"),
        "procfs_list": mod.procfs_list,
        "trace_export_json": lambda: _export_events(mod.trace_export_json()),
        "trace_export": lambda: [e["name"] for e in
                                 mod.trace_export()["traceEvents"]],
        "trace_save": saved,
        "metrics_text": lambda: _engine_lines(mod.metrics_text()),
        "journal.text": jour.text,
    }


@pytest.mark.parametrize("reader", [
    "journal_dump", "procfs_read", "procfs_list", "trace_export_json",
    "trace_export", "trace_save", "metrics_text", "journal.text"])
def test_readers_read_like_jax(reader, tmp_path):
    """Each reader returns what JAX's returns over the same engine state,
    and none comes back empty (the export holds the application span)."""
    utils.trace_reset()
    utils.trace_start()
    with utils.span("app.read", nbytes=1):
        pass
    utils.trace_stop()
    try:
        port = _readers(utils, journal, tmp_path)[reader]
        ref = _readers(jutils, jjournal, tmp_path)[reader]
        got, want = _stable(ref, port)
        assert got == want
        assert got
        if reader in ("trace_export_json", "trace_save"):
            assert "app.read" in {e["name"] for e in got}
    finally:
        utils.trace_reset()


# ------------------------------------------- chip_smoke phase 8, run N


def test_chip_smoke_native_trace_run_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke phase 8's runs D and N at a tiny shape on the CPU: the
    Scheduler of run A with streams on tenants i % 2 and each step in an
    application span, disarmed (D) and with the native trace armed (N).
    Their tokens are A's, and every check of ``NativeTrace.read`` holds on
    N (histograms, step spans, export, flow pairs, SLO series, ledgers,
    scrape); D leaves no trace records."""
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke
    from open_gpu_kernel_modules_tpu_torch.models import llama
    from open_gpu_kernel_modules_tpu_torch.runtime import sched

    monkeypatch.setattr(sched, "resolve", lambda d=None: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    # Phase 8's scheduling shape, narrowed (a page of 16 keeps the managed
    # backing at the engine's 64 KB least).
    monkeypatch.setattr(chip_smoke, "SCHED", dict(
        streams=8, first=5, prompt=112, new=32, max_seqs=8, max_len=160,
        page=16, tokens_per_round=8))
    cfg = dataclasses.replace(
        llama.LlamaConfig.tiny(vocab_size=256, max_seq_len=256),
        dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    prompts = np.random.default_rng(0).integers(0, 256, (8, 112)).astype(
        np.int32)
    try:
        a = chip_smoke.sched_run(cfg, params, prompts, 1)
        utils.trace_reset()
        span = chip_smoke.NativeTrace.STEP_SPAN
        d = chip_smoke.sched_run(cfg, params, prompts, 1, step_span=span)
        d_records = utils.trace_stats()["recorded"]
        native = chip_smoke.NativeTrace(str(tmp_path), "N1")
        n = chip_smoke.sched_run(cfg, params, prompts, 1, step_span=span,
                                 native_trace=native)
        armed_after = utils.trace_armed()
    finally:
        utils.trace_reset()
        utils.flow_reset()
    assert (d[0] == a[0]).all() and (n[0] == a[0]).all()
    assert n[1]["rounds"] == d[1]["rounds"] == a[1]["rounds"]
    assert d_records == 0 and not armed_after
    f = native.facts
    assert f["flows"]["paired"] >= 1
    assert f["export_dropped"] == 0
    assert f["export_bytes"] == os.path.getsize(
        tmp_path / "sched_trace_N1.json")
    assert f["trace_stats"]["recorded"] > 0
