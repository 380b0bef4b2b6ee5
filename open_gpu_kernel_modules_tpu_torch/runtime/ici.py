"""ICI topology, link management and peer apertures (native/src/ici.c).

The port's copy of the JAX package's ``runtime/ici.py``: each device's links
(peer, state, byte counters), link training, a forced link failure and a
link reset, the routed hop count between two devices (dimension-ordered
torus routing that detours around FAILED links), and ``PeerAperture``, a
peer-mapped window through which one ICI copy moves bytes between two
devices' HBM arenas. Topology state is process-wide in the native library.
"""

from __future__ import annotations

import ctypes
import enum
from dataclasses import dataclass

from . import native


class LinkState(enum.IntEnum):
    DOWN = 0
    TRAINING = 1
    ACTIVE = 2
    FAILED = 3


class _LinkInfo(ctypes.Structure):
    _fields_ = [
        ("peerInst", ctypes.c_uint32),
        ("state", ctypes.c_uint32),
        ("trainedAtNs", ctypes.c_uint64),
        ("bytesTx", ctypes.c_uint64),
        ("bytesRx", ctypes.c_uint64),
        ("errorCount", ctypes.c_uint32),
    ]


@dataclass(frozen=True)
class LinkInfo:
    peer: int
    state: LinkState
    bytes_tx: int
    bytes_rx: int
    error_count: int


_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is not None:
        return _bound
    lib = native.load()
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    lib.tpuIciLinkCount.argtypes = [u32]
    lib.tpuIciLinkCount.restype = u32
    lib.tpuIciLinkInfo.argtypes = [u32, u32, ctypes.POINTER(_LinkInfo)]
    lib.tpuIciLinkInfo.restype = u32
    lib.tpuIciInjectLinkFailure.argtypes = [u32, u32]
    lib.tpuIciInjectLinkFailure.restype = u32
    lib.tpuIciTrainLinks.argtypes = [u32]
    lib.tpuIciTrainLinks.restype = u32
    lib.tpuIciResetLink.argtypes = [u32, u32]
    lib.tpuIciResetLink.restype = u32
    lib.tpuIciRouteHops.argtypes = [u32, u32, ctypes.POINTER(u32)]
    lib.tpuIciRouteHops.restype = u32
    lib.tpuIciPeerApertureCreate.argtypes = [u32, u32,
                                             ctypes.POINTER(ctypes.c_void_p)]
    lib.tpuIciPeerApertureCreate.restype = u32
    lib.tpuIciPeerApertureDestroy.argtypes = [ctypes.c_void_p]
    lib.tpuIciPeerApertureDestroy.restype = None
    lib.tpuIciPeerCopy.argtypes = [ctypes.c_void_p, u64, u64, u64,
                                   ctypes.c_int]
    lib.tpuIciPeerCopy.restype = u32
    _bound = lib
    return lib


def _check(status: int, what: str) -> None:
    if status != 0:
        raise native.RmError(status, what)


def link_count(dev: int) -> int:
    return _lib().tpuIciLinkCount(dev)


def link_info(dev: int, link: int) -> LinkInfo:
    raw = _LinkInfo()
    _check(_lib().tpuIciLinkInfo(dev, link, ctypes.byref(raw)),
           "tpuIciLinkInfo")
    return LinkInfo(raw.peerInst, LinkState(raw.state), raw.bytesTx,
                    raw.bytesRx, raw.errorCount)


def train_links(dev: int) -> None:
    """Train every link of ``dev`` that is not ACTIVE."""
    _check(_lib().tpuIciTrainLinks(dev), "tpuIciTrainLinks")


def inject_link_failure(dev: int, link: int) -> None:
    _check(_lib().tpuIciInjectLinkFailure(dev, link),
           "tpuIciInjectLinkFailure")


def reset_link(dev: int, link: int) -> None:
    """Take a link down for retraining (a FAILED link comes back DOWN)."""
    _check(_lib().tpuIciResetLink(dev, link), "tpuIciResetLink")


def route_hops(src: int, dst: int) -> int:
    hops = ctypes.c_uint32()
    _check(_lib().tpuIciRouteHops(src, dst, ctypes.byref(hops)),
           "tpuIciRouteHops")
    return hops.value


class PeerAperture:
    """Peer-mapped HBM window from device ``src`` onto device ``peer``."""

    def __init__(self, src: int, peer: int):
        self._lib = _lib()
        handle = ctypes.c_void_p()
        _check(self._lib.tpuIciPeerApertureCreate(src, peer,
                                                  ctypes.byref(handle)),
               "tpuIciPeerApertureCreate")
        self._handle = handle

    def write(self, local_off: int, peer_off: int, size: int) -> None:
        """One ICI copy: ``size`` bytes from the local arena to the peer's."""
        _check(self._lib.tpuIciPeerCopy(self._handle, local_off, peer_off,
                                        size, 0), "tpuIciPeerCopy")

    def read(self, local_off: int, peer_off: int, size: int) -> None:
        """One ICI copy: ``size`` bytes from the peer's arena to the local."""
        _check(self._lib.tpuIciPeerCopy(self._handle, local_off, peer_off,
                                        size, 1), "tpuIciPeerCopy")

    def close(self) -> None:
        if self._handle:
            self._lib.tpuIciPeerApertureDestroy(self._handle)
            self._handle = None

    def __enter__(self) -> "PeerAperture":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
