"""The port's public surface against the JAX package's, on the CPU.

A signature test walks every module of the JAX package and fails if a public
function, class or method there has a parameter the port's counterpart
lacks, takes JAX's parameters in another order, or gives one another
default.  Two allowlists name the exceptions, each with its reason: the
parameters that are JAX or TPU idiom, and those that no caller in either
package passes, which the port keeps at JAX's default as a module constant
or as fixed behaviour until a ported caller needs them.  Then the code
behind those frozen parameters acts as JAX's at its default, through both
packages: the native tenant table after ``Scheduler.configure_tenant``, a
``Scheduler.run`` to its end, and the multichip pool's staging window,
initial tenant charges, verified migrations and retry budget
(``IciPoolBacking``, ``vac.migrate_pages``); the ``utils`` readers are held
in tests/test_torch_trace_surface.py.
"""

import importlib
import inspect
import os

import numpy as np
import pytest

import open_gpu_kernel_modules_tpu as jpkg
import open_gpu_kernel_modules_tpu_torch as tpkg
from open_gpu_kernel_modules_tpu.runtime import sched as jsched
from open_gpu_kernel_modules_tpu.uvm import managed as jmanaged
from open_gpu_kernel_modules_tpu_torch import utils
from open_gpu_kernel_modules_tpu_torch.runtime import sched as tsched
from open_gpu_kernel_modules_tpu_torch.uvm import managed as tmanaged

from test_torch_multichip import _run_pair
from torch_port_util import tiny_pair

JAX_NAME = jpkg.__name__
PORT_NAME = tpkg.__name__

#: (module under the package, qualified name) -> (JAX parameters the port
#: lacks, reason).  An entry whose parameter set is None is a name the port
#: lacks as a whole.
IDIOM_ONLY = {
    ("ops.flash_attention", "flash_attention"): (
        {"blk_q", "blk_k", "interpret"},
        "Pallas block sizes and interpret mode: the CUDA kernels choose "
        "their own tiles and the CPU runs the plain version"),
    ("parallel.mesh", "make_mesh"): (
        {"devices"},
        "a list of JAX devices: the port's mesh is torch.distributed ranks"),
    ("parallel.ring_attention", "ring_attention"): (
        {"axis_name"}, "a shard_map axis name: the port takes a process "
        "group"),
    ("parallel.ring_attention", "ring_attention_sharded"): (
        {"axis_name"}, "a shard_map axis name: the port takes a process "
        "group"),
    ("parallel.ulysses", "ulysses_attention"): (
        {"axis_name"}, "a shard_map axis name: the port takes a process "
        "group"),
    ("parallel.ulysses", "ulysses_attention_sharded"): (
        {"axis_name"}, "a shard_map axis name: the port takes a process "
        "group"),
    ("parallel.ring_attention", "shard_map_compat"): (
        None, "a shim over JAX's shard_map import paths"),
    ("models.llama", "init_params"): (
        {"key"}, "a JAX PRNG key: the port takes a torch.Generator"),
    ("models.serving", "generate"): (
        {"greedy"}, "the JAX body never reads it (decoding is greedy)"),
    ("models.serving", "StagedActivation.__init__"): (
        {"pad"}, "the padding of jit-static upload chunks: the port's "
        "eager uploads are not padded"),
}

#: No caller in either package passes these (JAX's own code at most passes
#: them through: ``make_multichip_cache`` to ``IciPoolBacking``,
#: ``configure_tenant`` to the native tenant table).  The port keeps each at
#: JAX's default, frozen where the value below reads it; a ported caller that
#: passes one brings the parameter back.
#: (module, qualified name, parameter) -> the port's frozen value.
FROZEN = {
    ("runtime.sched", "Scheduler.configure_tenant", "hbm_quota_pages"):
        lambda: _params(_port("uvm.managed").tenant_configure)[
            "hbm_quota_pages"].default,
    ("runtime.sched", "Scheduler.configure_tenant", "cxl_quota_pages"):
        lambda: _params(_port("uvm.managed").tenant_configure)[
            "cxl_quota_pages"].default,
    ("runtime.sched", "Scheduler.run", "max_rounds"):
        lambda: _port("runtime.sched").MAX_ROUNDS,
    ("uvm.vac", "migrate_pages", "retries"): lambda: _port("uvm.vac").RETRIES,
    # Every migration checks the shipped bytes' CRC.
    ("uvm.vac", "migrate_pages", "verify"): lambda: True,
    ("models.multichip", "IciPoolBacking.__init__", "staging_records"):
        lambda: _port("models.multichip").STAGING_RECORDS,
    # Every page's charge starts on tenant 0.
    ("models.multichip", "IciPoolBacking.__init__", "tenant_of_page"):
        lambda: None,
    ("models.multichip", "make_multichip_cache", "tenant_of_page"):
        lambda: None,
    ("utils", "journal_dump", "max_bytes"):
        lambda: _port("utils").JOURNAL_BYTES,
    ("utils", "procfs_read", "max_bytes"):
        lambda: _port("utils").PROCFS_BYTES,
    ("utils", "procfs_list", "max_bytes"):
        lambda: _port("utils").PROCFS_LIST_BYTES,
    ("utils", "trace_export_json", "max_bytes"):
        lambda: _port("utils").TRACE_EXPORT_BYTES,
    ("utils", "trace_export", "max_bytes"):
        lambda: _port("utils").TRACE_EXPORT_BYTES,
    ("utils", "trace_save", "max_bytes"):
        lambda: _port("utils").TRACE_EXPORT_BYTES,
    ("utils", "metrics_text", "max_bytes"):
        lambda: _port("utils").METRICS_BYTES,
    ("uvm.journal", "text", "max_bytes"):
        lambda: _port("uvm.journal").TEXT_BYTES,
}

#: (module, qualified name, parameter) -> reason, for defaults that differ.
DEFAULTS_DIFFER = {
    ("models.llama", "LlamaConfig.__init__", "dtype"): (
        "bfloat16 in each framework's own type"),
    ("runtime.hbm", "HbmRuntime.__init__", "block_bytes"): (
        "the engine's 512 KiB copy stripe: at 1 MiB a block re-uploads for "
        "each half that lands in another drain batch"),
}


def _port(sub):
    return importlib.import_module(f"{PORT_NAME}.{sub}")


def _allowed(sub, qual):
    """The JAX parameters of ``sub.qual`` the port may lack (None: the whole
    name)."""
    allowed, _ = IDIOM_ONLY.get((sub, qual), (set(), None))
    if allowed is None:
        return None
    return allowed | {p for (m, q, p) in FROZEN if (m, q) == (sub, qual)}


def _jax_modules():
    root = os.path.dirname(jpkg.__file__)
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), root)[:-3]
            rel = rel.replace(os.sep, ".")
            if rel == "__init__":
                yield ""
            else:
                yield rel[:-len(".__init__")] if rel.endswith(
                    ".__init__") else rel


def _defined_in(obj, modname) -> bool:
    for o in (obj, getattr(obj, "__wrapped__", None)):
        if getattr(o, "__module__", None) == modname:
            return True
    return False


def _public_callables(mod):
    """(qualified name, JAX object) of every public function, class and
    class method defined in ``mod``."""
    for name, obj in vars(mod).items():
        if name.startswith("_") or not callable(obj) or \
                not _defined_in(obj, mod.__name__):
            continue
        if inspect.isclass(obj):
            yield name, obj
            for mname, mobj in vars(obj).items():
                if inspect.isfunction(mobj) and (
                        not mname.startswith("_") or mname == "__init__"):
                    yield f"{name}.{mname}", mobj
        else:
            yield name, obj


def _params(fn):
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None


def _lookup(mod, qualname):
    obj = mod
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _surface_gaps():
    gaps = []
    for sub in _jax_modules():
        jmod = importlib.import_module(".".join(filter(None, (JAX_NAME,
                                                              sub))))
        tmod = importlib.import_module(".".join(filter(None, (PORT_NAME,
                                                              sub))))
        for qual, jobj in _public_callables(jmod):
            allowed = _allowed(sub, qual)
            tobj = _lookup(tmod, qual)
            if tobj is None:
                if allowed is not None:
                    gaps.append(f"{sub}.{qual}: missing in the port")
                continue
            jp, tp = _params(jobj), _params(tobj)
            if jp is None or tp is None or inspect.isclass(jobj):
                continue
            want = [p for p in jp if p not in allowed]
            missing = [p for p in want if p not in tp]
            if missing:
                gaps.append(f"{sub}.{qual}: lacks {missing}")
                continue
            if not allowed and list(tp)[:len(want)] != want:
                gaps.append(f"{sub}.{qual}: order {list(tp)} not {want}")
            for p in want:
                dj, dt = jp[p].default, tp[p].default
                if dj is not inspect.Parameter.empty and \
                        repr(dj) != repr(dt) and \
                        (sub, qual, p) not in DEFAULTS_DIFFER:
                    gaps.append(f"{sub}.{qual}({p}): default {dt!r}, "
                                f"JAX {dj!r}")
    return gaps


def test_public_signatures_cover_jax():
    """Every public JAX function and method has its port, taking JAX's
    parameters in JAX's order with JAX's defaults, but for the idiom-only
    allowlists."""
    assert _surface_gaps() == []


def test_allowlist_entries_are_still_gaps():
    """Each allowlisted gap is a real one (a stale entry would hide a later
    regression)."""
    for (sub, qual), (allowed, reason) in IDIOM_ONLY.items():
        assert reason
        jobj = _lookup(importlib.import_module(f"{JAX_NAME}.{sub}"), qual)
        tobj = _lookup(importlib.import_module(f"{PORT_NAME}.{sub}"), qual)
        assert jobj is not None, (sub, qual)
        if allowed is None:
            assert tobj is None, (sub, qual)
        else:
            assert allowed <= set(_params(jobj)), (sub, qual)
            assert not allowed & set(_params(tobj)), (sub, qual)
    for sub, qual, param in FROZEN:
        jobj = _lookup(importlib.import_module(f"{JAX_NAME}.{sub}"), qual)
        assert param in _params(jobj), (sub, qual, param)
        assert param not in _params(_lookup(_port(sub), qual)), \
            (sub, qual, param)


def test_version_is_jax_version():
    assert tpkg.__version__ == jpkg.__version__


@pytest.mark.parametrize("module,qual,param", sorted(FROZEN))
def test_frozen_parameters_keep_jax_defaults(module, qual, param):
    """Each parameter the port keeps frozen has JAX's default as its value:
    a JAX caller that leaves it out gets the same behaviour."""
    jfn = _lookup(importlib.import_module(f"{JAX_NAME}.{module}"), qual)
    assert FROZEN[(module, qual, param)]() == _params(jfn)[param].default


# ---------------------------------------------------------------- sched


@pytest.fixture(scope="module")
def setup():
    return tiny_pair(vocab_size=256, max_seq_len=256, num_kv_heads=4,
                     rope_theta=500000.0)


def _sched(side, setup):
    jcfg, jparams, tcfg, tparams = setup
    args = dict(max_seqs=4, max_len=128, page_size=16, oversub=1,
                tokens_per_round=4)
    if side == "jax":
        return jsched.Scheduler(jcfg, jparams, **args)
    return tsched.Scheduler(tcfg, tparams, device="cpu", **args)


def test_configure_tenant_native_table(setup):
    """``configure_tenant(1, priority=120)`` programs the native tenant
    table as JAX's does, its tier quotas at JAX's default of 0."""
    infos = {}
    try:
        for side, managed in (("jax", jmanaged), ("port", tmanaged)):
            managed.tenant_configure(1)
            s = _sched(side, setup)
            try:
                s.configure_tenant(1, priority=120)
                infos[side] = (jmanaged.tenant_info(1),
                               tmanaged.tenant_info(1))
                assert s.tenants[1].priority == 120
            finally:
                s.close()
    finally:
        tmanaged.tenant_configure(1)
    jinfo, pinfo = infos["port"]
    assert (pinfo.priority, pinfo.hbm_quota_pages,
            pinfo.cxl_quota_pages) == (120, 0, 0)
    assert dict(vars(pinfo)) == dict(vars(jinfo))
    assert dict(vars(pinfo)) == dict(vars(infos["jax"][1]))


def test_run_to_the_end(setup):
    """``run()`` drives every stream to its end inside the round budget,
    with JAX's report keys, rounds and tokens."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 256, size=20) for _ in range(3)]
    got = {}
    utils.flow_reset()
    try:
        for side in ("jax", "port"):
            s = _sched(side, setup)
            try:
                reqs = [s.submit(p, max_new_tokens=16) for p in prompts]
                rep = s.run()
                assert s.idle
                got[side] = (rep, [r.tokens.tolist() for r in reqs])
            finally:
                s.close()
            utils.flow_reset()
    finally:
        utils.flow_reset()
    (jrep, jtok), (rep, tok) = got["jax"], got["port"]
    assert set(rep) == set(jrep)
    assert rep["rounds"] == jrep["rounds"] < tsched.MAX_ROUNDS
    assert rep["finished"] == jrep["finished"] == 3
    assert rep["decoded_tokens"] == jrep["decoded_tokens"] == 3 * 16
    assert tok == jtok


# ------------------------------------------------------ multichip and vac

# Config #5's pool built by hand (tiny, fp32, 4 sequences of 64 tokens in
# pages of 8 over four arenas); two groups decode through it, then three
# migrations: 1 -> 2 and 2 -> 3, verified, and 3 -> 0 with the vac.migrate
# site hitting every evaluation, which must spend the retry budget and
# abort; then the groups decode again over the moved records.
_POOL_BODY = r"""
import ctypes
from PKG import utils
from PKG.uvm import inject as inj, vac

out = {}
m = 64 // 8
pool_shape = (cfg.num_layers, 4 * m, 8, cfg.num_kv_heads, cfg.head_dim)
page_bytes = 8 * cfg.num_kv_heads * cfg.head_dim * np_dtype.itemsize
backing = multichip.IciPoolBacking(pool_shape, np_dtype, page_bytes, 4)
lib = backing._lib
lib.uvmTenantDevPages.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
lib.uvmTenantDevPages.restype = ctypes.c_uint64


def charges():
    return [int(lib.uvmTenantDevPages(0, d)) for d in range(4)]


out["staging"] = len(backing._staging)
out["charges0"] = charges()
cache = serving.TieredKVCache(cfg, 4, 64, page_size=8, oversub=4,
                              backing=backing, **extra)
groups = [[0, 1], [2, 3]]
for g in groups:
    serving.prefill_group(cfg, params, cache, g, group_prompts(g))
serving.decode_rounds(cfg, params, cache, groups, 2, 1)
cache.drain_flushes()
out["tokens"] = [int(t) for t in cache.last_token]

names = ("vac_crc_verifies", "vac_inject_retries", "vac_inject_aborts",
         "vac_pages_moved", "vac_commits", "vac_aborts")


def ctr():
    return {n: utils.counter(n) for n in names}


def delta(c0):
    c1 = ctr()
    return {n: c1[n] - c0[n] for n in names}


utils.trace_reset()
utils.trace_start()
for src, dst in ((1, 2), (2, 3)):
    c0 = ctr()
    rep = vac.migrate_pages(backing, src, dst)
    out[f"moved_{src}_{dst}"] = [rep.pages, rep.retries, delta(c0)]
homed3 = list(backing.pages_homed(3))
_, h0 = inj.counts(inj.Site.VAC_MIGRATE)
c0 = ctr()
inj.enable(inj.Site.VAC_MIGRATE, inj.Mode.NTH, 1)
try:
    vac.migrate_pages(backing, 3, 0)
    out["aborted"] = False
except vac.VacAbort:
    out["aborted"] = True
finally:
    inj.disable(inj.Site.VAC_MIGRATE)
_, h1 = inj.counts(inj.Site.VAC_MIGRATE)
out["exhausted"] = [delta(c0), h1 - h0, backing.pages_homed(3) == homed3]
utils.trace_stop()
out["vac_spans"] = utils.trace_hist_count("vac.migrate")
utils.trace_reset()
out["charges1"] = charges()
out["homed"] = [len(backing.pages_homed(d)) for d in range(4)]
serving.decode_rounds(cfg, params, cache, groups, 2, 1)
cache.drain_flushes()
out["tokens2"] = [int(t) for t in cache.last_token]
out["stats"] = dict(backing.stats)
cache.close()
"""

_POOL_JAX = r"""
prompts = jax.random.randint(jax.random.key(5), (4, 15), 0, cfg.vocab_size)
save(prompts)
np_dtype = np.dtype(cfg.dtype)
extra = {}


def group_prompts(g):
    return prompts[np.array(g)]
""" + _POOL_BODY.replace("PKG", "open_gpu_kernel_modules_tpu") + r"""
print(json.dumps(out))
"""

_POOL_PORT = r"""
np_dtype = serving._np_dtype(cfg.dtype)
extra = {"device": "cpu"}


def group_prompts(g):
    return torch.as_tensor(prompts[g])
""" + _POOL_BODY.replace("PKG", "open_gpu_kernel_modules_tpu_torch") + r"""
done(out)
"""


def test_pool_staging_tenants_and_vac_defaults_match_jax(tmp_path):
    """Through both packages in four-arena children: the staging window of
    STAGING_RECORDS records, every page first charged to tenant 0, and the
    same tokens; each verified move makes one CRC check a record; with the
    vac.migrate site hitting every evaluation a move spends RETRIES retries
    and aborts (site hits = retries + aborts) and moves nothing; every move
    emits a vac.migrate span; charges follow the homes; tokens after the
    moves are JAX's."""
    jx, pt = _run_pair(tmp_path, _POOL_JAX, _POOL_PORT)
    pt.pop("jax_imported")
    assert pt == jx, (pt, jx)
    assert pt["staging"] == _port("models.multichip").STAGING_RECORDS
    # 32 pages round-robin over 4 arenas, all on tenant 0.
    assert pt["charges0"] == [8, 8, 8, 8]
    for key, pages in (("moved_1_2", 8), ("moved_2_3", 16)):
        moved, retries, d = pt[key]
        assert moved == pages and retries == 0
        assert d["vac_crc_verifies"] == pages
        assert d["vac_pages_moved"] == pages and d["vac_commits"] == 1
    assert pt["aborted"]
    d, hits, unmoved = pt["exhausted"]
    retries = _port("uvm.vac").RETRIES
    assert d["vac_inject_retries"] == retries
    assert d["vac_inject_aborts"] == 1
    assert hits == d["vac_inject_aborts"] + d["vac_inject_retries"]
    assert d["vac_pages_moved"] == 0 and d["vac_aborts"] == 1 and unmoved
    assert pt["vac_spans"] == 3
    assert pt["homed"] == [8, 0, 0, 24]
    assert pt["charges1"] == pt["homed"]
    assert pt["stats"]["ici_fetch_records"] > 0
