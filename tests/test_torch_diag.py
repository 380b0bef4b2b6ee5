"""The port's diagnostics, external-mapping and REMOTE-tier surfaces against
the JAX package's, on the CPU.

The tests of tests/test_diag_surface.py, tests/test_external.py and
tests/test_remote_tier.py, run through the port (``utils``, ``uvm``,
``runtime.native``) with every assertion of the JAX tests.  Where a result
does not depend on timing it is also read, or run, through the JAX package,
which is the reference: registry resolution, the procfs nodes and their
listing, counters, the journal, the external window's bytes, the processor
UUID table, and the REMOTE tier's residency and ledgers.  The REMOTE tier
needs four native devices and ``TPUMEM_REMOTE_TIER`` before the library
loads, so it runs in one child process per package, side by side.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from open_gpu_kernel_modules_tpu import utils as jutils
from open_gpu_kernel_modules_tpu import uvm as juvm
from open_gpu_kernel_modules_tpu.runtime import native as jnative
from open_gpu_kernel_modules_tpu_torch import utils, uvm
from open_gpu_kernel_modules_tpu_torch.runtime import native

from test_external import (MAP_ANONYMOUS, MAP_NORESERVE, MAP_PRIVATE,
                           PROT_NONE, UVM_INITIALIZE,
                           UVM_TOOLS_GET_PROCESSOR_UUID_TABLE,
                           InitializeParams, UuidTableParams, _bind, _libc)
from test_remote_tier import _SCRIPT as _REMOTE_SCRIPT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (juvm, jnative), "port": (uvm, native)}


def _same(read_jax, read_port, tries=5):
    """The port's read of a value background engine threads may move
    equals a JAX read taken just before or just after it."""
    for _ in range(tries):
        before = read_jax()
        got = read_port()
        after = read_jax()
        if got in (before, after):
            return True
    return False


# ------------------------------------------------------------ diagnostics


def test_counters_and_journal_reflect_engine_activity():
    before = utils.counter("channel_pushes")
    with uvm.VaSpace() as vs:
        buf = vs.alloc(1 << 20)
        buf.view()[:] = 3
        buf.device_access(dev=0)
        buf.free()
    assert utils.counter("channel_pushes") > before

    lines = utils.journal_dump()
    assert lines
    assert any("fault engine ready" in ln or "enumerated" in ln
               for ln in lines)
    assert _same(jutils.journal_dump, utils.journal_dump)

    names = ["channel_pushes", "uvm_fault_batches"]
    got = utils.counters(names)
    assert set(got) == set(names)
    assert _same(lambda: jutils.counters(names), lambda: utils.counters(names))


def test_registry_matches_native_resolution(monkeypatch):
    monkeypatch.setenv("TPUMEM_SOME_TEST_KNOB", "0x40")
    assert utils.registry_get("some_test_knob") == 64
    assert utils.registry_get("absent_knob", 7) == 7
    monkeypatch.setenv("TPUMEM_BAD_KNOB", "zzz")
    assert utils.registry_get("bad_knob", 9) == 9
    for key, default in (("some_test_knob", None), ("absent_knob", 7),
                         ("bad_knob", 9), ("SOME_TEST_KNOB", 3)):
        assert utils.registry_get(key, default) == \
            jutils.registry_get(key, default), key


def test_procfs_nodes(monkeypatch):
    info = utils.procfs_read("/proc/driver/nvidia/gpus/0/information")
    assert "Device Instance:" in info and "Arena Backend:" in info
    ver = utils.procfs_read("driver/tpurm/version")
    assert "tpurm version" in ver
    stats = utils.procfs_read("/proc/driver/nvidia-uvm/fault_stats")
    assert "cpu_faults:" in stats and "service_p50_ns:" in stats
    assert utils.procfs_read("driver/tpurm-uvm/counters") == ""
    monkeypatch.setenv("TPUMEM_PROCFS_DEBUG", "1")
    body = utils.procfs_read("driver/tpurm-uvm/counters")
    assert "channel_pushes" in body
    chans = utils.procfs_read("driver/tpurm/channels")
    assert "completed=" in chans
    nodes = utils.procfs_list()
    assert "driver/tpurm/version" in nodes
    assert "driver/tpurm/channels" in nodes
    events = utils.procfs_read("driver/tpurm-uvm/tools_events")
    assert "reference(UvmEventType)" in events
    assert "GpuFaultReplay" in events and "MapRemote" in events
    rdma = utils.procfs_read("driver/tpurm/rdma")
    assert "EMULATED" in rdma and "ib_mr_registrations" in rdma

    # The same nodes read through the JAX surface.
    assert nodes == jutils.procfs_list()
    for node in ("driver/tpurm/version", "driver/tpurm-uvm/tools_events",
                 "/proc/driver/nvidia/gpus/0/information"):
        assert _same(lambda: jutils.procfs_read(node),
                     lambda: utils.procfs_read(node)), node


# ------------------------------------------------------ external mappings


def _external_window(pkg):
    """tests/test_external.py's external-range scenario through one
    package: statuses of each call and the bytes seen either side."""
    pkg_uvm, pkg_native = PACKAGES[pkg]
    lib = _bind(pkg_native.load())
    libc = _libc()
    length = 1 << 20
    out = {}
    with pkg_uvm.VaSpace() as vs:
        base = libc.mmap(None, length, PROT_NONE,
                         MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0)
        assert base not in (None, ctypes.c_void_p(-1).value)
        try:
            out["create"] = lib.uvmExternalRangeCreate(vs._handle, base,
                                                       length)
            arena_off = 4 << 20
            buf = ctypes.c_void_p()
            out["export"] = lib.tpuDmabufExport(0, arena_off, length,
                                                ctypes.byref(buf))
            out["map"] = lib.uvmMapExternal(vs._handle, base, length, buf, 0)
            win = np.frombuffer(
                (ctypes.c_char * length).from_address(base), np.uint8)
            win[: 4096] = 0xC7
            shadow_base, _ = pkg_native.hbm_view(0)
            shadow = np.frombuffer(
                (ctypes.c_char * length).from_address(
                    shadow_base + arena_off), np.uint8)
            out["shadow"] = [int(shadow[0]), int(shadow[4095])]
            shadow[8192] = 0x5D
            out["window"] = int(win[8192])
            out["flush"] = lib.uvmExternalFlush(vs._handle, base, length)
            out["unmap"] = lib.uvmUnmapExternal(vs._handle, base, length)
            out["free"] = lib.uvmMemFree(vs._handle, base)
            lib.tpuDmabufPut(buf)
        finally:
            libc.munmap(base, length)
    return out


def test_external_range_aliases_device_arena():
    out = _external_window("port")
    assert out == {"create": 0, "export": 0, "map": 0,
                   "shadow": [0xC7, 0xC7], "window": 0x5D, "flush": 0,
                   "unmap": 0, "free": 0}
    assert out == _external_window("jax")


def _uvm_fd_mmap(pkg):
    pkg_uvm, pkg_native = PACKAGES[pkg]
    lib = _bind(pkg_native.load())
    pfd = lib.tpurm_open(b"/dev/tpu-uvm")
    assert pfd >= 0
    out = {}
    try:
        out["before_init"] = lib.tpurm_mmap(pfd, 1 << 20) in (None,
                                                              2**64 - 1)
        init = InitializeParams()
        out["init"] = [lib.tpurm_ioctl(pfd, UVM_INITIALIZE,
                                       ctypes.byref(init)), init.rmStatus]
        base = lib.tpurm_mmap(pfd, 1 << 20)
        out["mapped"] = base not in (None, 2**64 - 1)
        view = np.frombuffer(
            (ctypes.c_char * (1 << 20)).from_address(base), np.uint8)
        before = pkg_uvm.fault_stats()
        view[:] = 0x3C
        out["byte"] = int(view[12345])
        out["faulted"] = pkg_uvm.fault_stats().faults_cpu > before.faults_cpu
        out["munmap"] = [lib.tpurm_munmap_hook(base, 1 << 20),
                         lib.tpurm_munmap_hook(base, 1 << 20)]
    finally:
        lib.tpurm_close(pfd)
    return out


def test_uvm_fd_mmap_creates_managed_range():
    """mmap on the uvm pseudo-fd is a managed-memory entry point (refused
    before INITIALIZE; faults populate; the munmap hook frees it once)."""
    out = _uvm_fd_mmap("port")
    assert out == {"before_init": True, "init": [0, 0], "mapped": True,
                   "byte": 0x3C, "faulted": True, "munmap": [1, 0]}
    assert out == _uvm_fd_mmap("jax")


def _uuid_table(pkg):
    _, pkg_native = PACKAGES[pkg]
    lib = _bind(pkg_native.load())
    pfd = lib.tpurm_open(b"/dev/tpu-uvm")
    assert pfd >= 0
    try:
        init = InitializeParams()
        assert lib.tpurm_ioctl(pfd, UVM_INITIALIZE, ctypes.byref(init)) == 0
        table = (ctypes.c_uint8 * (16 * 8))()
        p = UuidTableParams()
        p.tablePtr = ctypes.addressof(table)
        p.count = 8
        status = lib.tpurm_ioctl(pfd, UVM_TOOLS_GET_PROCESSOR_UUID_TABLE,
                                 ctypes.byref(p))
        return status, p.rmStatus, int(p.count), bytes(table)
    finally:
        lib.tpurm_close(pfd)


def test_tools_processor_uuid_table():
    status, rm_status, count, table = _uuid_table("port")
    assert status == 0 and rm_status == 0
    assert count >= 3
    assert table[0:16] == b"\x00" * 16
    assert table[16:19] == b"TPU"
    last = (count - 1) * 16
    assert table[last:last + 3] == b"CXL"
    assert (status, rm_status, count, table) == _uuid_table("jax")


# ------------------------------------------------------------ REMOTE tier


def _remote_children():
    """tests/test_remote_tier.py's script through each package, in two
    children side by side with four devices and the REMOTE tier on."""
    env = dict(os.environ, TPUMEM_FAKE_TPU_COUNT="4", TPUMEM_FAKE_HBM_MB="64",
               TPUMEM_REMOTE_TIER="1", TPUMEM_REMOTE_HEADROOM_PCT="0")
    jax_script = _REMOTE_SCRIPT % {"repo": REPO}
    port_script = jax_script.replace("open_gpu_kernel_modules_tpu",
                                     "open_gpu_kernel_modules_tpu_torch")
    port_script += ("\nassert not any(m == 'jax' or m.startswith('jax.') "
                    "for m in sys.modules)\n")
    procs = {name: subprocess.Popen([sys.executable, "-c", script], env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, script in (("jax", jax_script),
                                  ("port", port_script))}
    outs = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"{name} child: {err[-3000:]}"
            outs[name] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs["jax"], outs["port"]


def test_remote_tier_python_surface():
    """Demotion under arena pressure parks the span REMOTE on a lender
    chip with the HOST copy kept, the ledgers and the gauge show the lease,
    a device read promotes over ICI with the lease kept, an exclusive
    migrate drains it, and the data survives -- through the port, with the
    JAX package's residency, lender and counts."""
    jx, out = _remote_children()
    assert out["remote_after_evict"], out
    assert out["host_after_evict"], out
    assert not out["hbm_after_evict"], out
    assert out["lender"] != 0, out
    assert out["demotes"] >= 1, out
    assert out["demote_bytes"] > 0, out
    assert out["borrowed_pages_dev0"] > 0, out
    assert out["lent_bytes_lender"] > 0, out
    assert out["gauge_typed"], out
    assert out["gauge_sample"], out
    assert float(out["gauge_sample"].split()[-1]) > 0, out
    assert out["hbm_after_read"], out
    assert out["remote_after_read"], out
    assert out["promotes"] >= 1, out
    assert not out["remote_after_promote"], out
    assert out["hbm_after_promote"], out
    assert out["borrowed_after_promote"] == 0, out
    assert out["intact"], out
    assert out == jx, (out, jx)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_residency_fields(pkg):
    """``ResidencyInfo`` carries the REMOTE tier's ``remote`` and
    ``remote_lender`` in both packages, with the same field names."""
    pkg_uvm, _ = PACKAGES[pkg]
    with pkg_uvm.VaSpace() as vs:
        buf = vs.alloc(1 << 20)
        buf.view()[:] = 1
        r = buf.residency()
        assert r.remote is False and r.remote_lender == 0
        buf.free()
    names = [f for f in vars(juvm.ResidencyInfo)["__dataclass_fields__"]]
    assert list(vars(uvm.ResidencyInfo)["__dataclass_fields__"]) == names
