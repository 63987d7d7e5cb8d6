"""Process bootstrap + rank-ordered exchange for the cluster runtime
(counterpart of ``repro.cluster.runtime``).

The paper's GoFFish deployment (§V) is N commodity workers, each owning
one GoFS shard, coordinated over Ethernet.  This module is that shape for
the blocked engine:

* :func:`init_cluster` boots one process of an N-process run.  With
  ``num_processes == 1`` (the default when no coordinator is configured)
  it returns a no-op single-process runtime — every cluster-aware call
  site degrades to the single-process behaviour, so the subsystem is
  inert unless explicitly launched.  Multi-process, it optionally
  initializes ``torch.distributed`` with the ``gloo`` backend (the
  control plane: process ranks and a store) and always stands up the
  :class:`TcpExchange` the host-lane primitives ride on.
* :class:`TcpExchange` is a root-relayed, rank-ordered allgather over
  TCP: every process contributes one tagged payload per operation, the
  root (process 0) collects them in PROCESS-ID order and broadcasts the
  full list back.  Rank order is the load-bearing property — the
  boundary-fold seam (:class:`repro_torch.cluster.gather.ClusterGather`)
  concatenates the per-process partition buffers in this order, which
  is exactly what makes the distributed fold bitwise-identical to the
  single-process ``_host_fold_*`` left fold.
* Operations are SEQUENCED: process k's i-th operation pairs with every
  other process's i-th operation, and the root verifies all N tags
  match before combining — a divergent schedule (one process staging a
  different chunk, or running a different analytic order) fails fast
  with the mismatching tags instead of silently folding unrelated
  buffers.

The wire format is the reference's — length-prefixed pickle frames,
``("hello", pid)``, ``(seq, tag, payload)``, ``("ok", seq, parts)`` and
``("error", msg)`` — so processes of either package can share one
exchange.  Payloads are numpy arrays and Python values, never tensors.

The exchange moves ``2 * payload`` bytes per worker per op (up to root,
full list back); ``TcpExchange.ops`` and ``bytes_sent`` /
``bytes_received`` count what this process moved.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: Environment knobs the worker entrypoint (``launch/cluster_graph.py``)
#: sets for each spawned process.
ENV_COORDINATOR = "GOFFISH_COORDINATOR"
ENV_NUM_PROCESSES = "GOFFISH_NUM_PROCESSES"
ENV_PROCESS_ID = "GOFFISH_PROCESS_ID"
ENV_TRANSPORT = "GOFFISH_TRANSPORT"

TRANSPORTS = ("tcp", "torch", "auto")

_LEN = struct.Struct("<Q")


def _send_frame(sock: socket.socket, obj: Any) -> int:
    """Send one frame; returns the bytes put on the wire."""
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)
    return _LEN.size + len(data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("cluster exchange peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Tuple[Any, int]:
    """Receive one frame; returns it and the bytes taken off the wire."""
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n)), _LEN.size + n


class ExchangeError(RuntimeError):
    """A cross-process schedule divergence (mismatched operation tags) or
    a dead peer.  Fail-fast by design: a divergent schedule would
    otherwise fold unrelated boundary buffers."""


class TcpExchange:
    """Root-relayed rank-ordered allgather among N processes.

    Process 0 listens; workers connect and identify themselves by
    process id.  Every :meth:`allgather` is one sequenced operation:
    all N processes must call it with the SAME tag, in the same order —
    the root verifies and relays, so results arrive in process-id order
    on every participant.

    >>> import threading
    >>> out = {}
    >>> def peer(pid, port):
    ...     ex = (TcpExchange.listen(port, 2, host="127.0.0.1") if pid == 0
    ...           else TcpExchange.connect("127.0.0.1", port, 1, 2))
    ...     out[pid] = ex.allgather("demo", pid * 10)
    ...     ex.close()
    >>> with socket.socket() as s:
    ...     s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]
    >>> ts = [threading.Thread(target=peer, args=(p, port)) for p in (0, 1)]
    >>> for t in ts: t.start()
    >>> for t in ts: t.join(60)
    >>> out[0], out[1]
    ([0, 10], [0, 10])
    """

    def __init__(self, process_id: int, num_processes: int, *,
                 timeout: float = 120.0):
        assert 0 <= process_id < num_processes
        self.process_id = process_id
        self.num_processes = num_processes
        self.timeout = timeout
        self._seq = 0
        self._lock = threading.Lock()
        self._closed = False
        self._listener: Optional[socket.socket] = None
        # root: sockets to workers 1..N-1 (index pid); worker: socket to root
        self._peers: Dict[int, socket.socket] = {}
        self._root_sock: Optional[socket.socket] = None
        # what this process moved: sequenced operations and frame bytes
        self.ops = 0
        self.bytes_sent = 0
        self.bytes_received = 0

    # ------------------------------------------------------------ wiring
    @classmethod
    def listen(cls, port: int, num_processes: int, *, host: str = "",
               timeout: float = 120.0) -> "TcpExchange":
        """Process 0: bind, accept the N-1 workers, return the exchange."""
        ex = cls(0, num_processes, timeout=timeout)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host or "0.0.0.0", port))
        srv.listen(num_processes)
        srv.settimeout(timeout)
        ex._listener = srv
        try:
            for _ in range(num_processes - 1):
                conn, _addr = srv.accept()
                conn.settimeout(timeout)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                hello = ex._recv(conn)
                if not (isinstance(hello, tuple) and hello[0] == "hello"):
                    raise ExchangeError(f"bad hello frame: {hello!r}")
                pid = int(hello[1])
                if pid in ex._peers or not (1 <= pid < num_processes):
                    raise ExchangeError(f"duplicate/invalid worker id {pid}")
                ex._peers[pid] = conn
        except BaseException:
            ex.close()
            raise
        return ex

    @classmethod
    def connect(cls, host: str, port: int, process_id: int,
                num_processes: int, *, timeout: float = 120.0,
                retry_for: float = 30.0) -> "TcpExchange":
        """Worker: dial the root (retrying while it boots) and say hello."""
        ex = cls(process_id, num_processes, timeout=timeout)
        deadline = time.monotonic() + retry_for
        while True:
            try:
                sock = socket.create_connection((host, port), timeout=timeout)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        sock.settimeout(timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        ex._root_sock = sock
        ex._send(sock, ("hello", process_id))
        return ex

    def _send(self, sock: socket.socket, obj: Any) -> None:
        self.bytes_sent += _send_frame(sock, obj)

    def _recv(self, sock: socket.socket) -> Any:
        obj, n = _recv_frame(sock)
        self.bytes_received += n
        return obj

    # --------------------------------------------------------- operations
    def allgather(self, tag: str, payload: Any) -> List[Any]:
        """All N processes contribute ``payload``; everyone receives the
        N payloads in process-id order.  Tags must match across processes
        (verified at the root) — the consistency check."""
        with self._lock:
            if self._closed:
                raise ExchangeError("exchange is closed")
            seq = self._seq
            self._seq += 1
            self.ops += 1
            if self.process_id == 0:
                return self._root_gather(seq, tag, payload)
            return self._worker_gather(seq, tag, payload)

    def _root_gather(self, seq: int, tag: str, payload: Any) -> List[Any]:
        parts: List[Any] = [None] * self.num_processes
        parts[0] = payload
        tags = {0: tag}
        for pid in range(1, self.num_processes):
            fseq, ftag, fpayload = self._checked(self._recv(self._peers[pid]))
            if fseq != seq:
                self._fail(f"process {pid} is at op {fseq}, root at {seq}")
            tags[pid] = ftag
            parts[pid] = fpayload
        if len(set(tags.values())) != 1:
            self._fail(f"divergent op tags at seq {seq}: {tags}")
        reply = ("ok", seq, parts)
        for pid in range(1, self.num_processes):
            self._send(self._peers[pid], reply)
        return parts

    def _worker_gather(self, seq: int, tag: str, payload: Any) -> List[Any]:
        self._send(self._root_sock, (seq, tag, payload))
        _status, rseq, parts = self._checked(self._recv(self._root_sock))
        if rseq != seq:
            raise ExchangeError(f"reply for op {rseq}, expected {seq}")
        return parts

    def _checked(self, frame: Any) -> Any:
        if isinstance(frame, tuple) and frame and frame[0] == "error":
            raise ExchangeError(frame[1])
        return frame

    def _fail(self, msg: str) -> None:
        err = ("error", msg)
        for sock in self._peers.values():
            try:
                self._send(sock, err)
            except OSError:
                pass
        raise ExchangeError(msg)

    def barrier(self, tag: str = "barrier") -> None:
        self.allgather(tag, None)

    def stats(self) -> Dict[str, int]:
        """Operations and frame bytes this process moved so far."""
        return {"ops": self.ops, "bytes_sent": self.bytes_sent,
                "bytes_received": self.bytes_received}

    # -------------------------------------------------------------- close
    def close(self) -> None:
        self._closed = True
        socks = list(self._peers.values()) + [self._root_sock,
                                               self._listener]
        self._peers.clear()
        self._root_sock = self._listener = None
        for sock in socks:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass


def shard_range(n_parts: int, process_id: int,
                num_processes: int) -> Tuple[int, int]:
    """The contiguous half-open partition range process ``process_id``
    owns out of ``n_parts`` partitions over ``num_processes`` processes.

    Contiguity in process-id order is what lets the gather seam
    re-assemble the global (P, NB) publish buffer by plain concatenation
    — the fold association (0..P-1) is then identical to the
    single-process stacked fold, hence bitwise-equal results.  Remainder
    partitions go to the lowest-id processes.

    >>> [shard_range(7, pid, 3) for pid in range(3)]
    [(0, 3), (3, 5), (5, 7)]
    """
    assert n_parts >= num_processes, \
        f"{n_parts} partitions cannot shard over {num_processes} processes"
    base, rem = divmod(n_parts, num_processes)
    lo = process_id * base + min(process_id, rem)
    hi = lo + base + (1 if process_id < rem else 0)
    return lo, hi


class ClusterRuntime:
    """One process's view of the N-process GoFFish cluster.

    ``num_processes == 1`` (no exchange) is the inert single-process
    fallback: every primitive is a local no-op, ``partition_shard``
    returns the full range, and nothing touches the network — engines
    and sessions can hold a runtime unconditionally.

    >>> rt = ClusterRuntime(0, 1)
    >>> rt.is_distributed
    False
    >>> rt.partition_shard(4)
    (0, 4)
    >>> rt.all_reduce_or(False)
    False
    """

    def __init__(self, process_id: int = 0, num_processes: int = 1,
                 exchange: Optional[TcpExchange] = None,
                 dist_initialized: bool = False):
        assert 0 <= process_id < num_processes
        assert (num_processes == 1) == (exchange is None), \
            "multi-process runtimes need an exchange; single-process none"
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.exchange = exchange
        # torch.distributed was initialized for this run (and is torn
        # down by close())
        self.dist_initialized = dist_initialized

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    # --------------------------------------------------- shard assignment
    def partition_shard(self, n_parts: int,
                        process_id: Optional[int] = None) -> Tuple[int, int]:
        """The contiguous half-open partition range this process (or
        ``process_id``) owns: :func:`shard_range`."""
        pid = self.process_id if process_id is None else process_id
        return shard_range(n_parts, pid, self.num_processes)

    def shard_of_partition(self, part: int, n_parts: int) -> int:
        """Inverse map: which process owns partition ``part``."""
        for pid in range(self.num_processes):
            lo, hi = self.partition_shard(n_parts, pid)
            if lo <= part < hi:
                return pid
        raise ValueError(part)

    # ----------------------------------------------------- host exchange
    def allgather(self, tag: str, payload: Any) -> List[Any]:
        """Rank-ordered allgather (single-process: the 1-element list)."""
        if self.exchange is None:
            return [payload]
        return self.exchange.allgather(tag, payload)

    def allgather_concat(self, arr: np.ndarray, *, axis: int = 0,
                         tag: str = "concat") -> np.ndarray:
        """Concatenate per-process arrays along ``axis`` in rank order."""
        arr = np.asarray(arr)
        parts = self.allgather(tag, arr)
        if len(parts) == 1:
            return arr
        return np.concatenate(parts, axis=axis)

    def all_reduce_or(self, flag, *, tag: str = "or") -> bool:
        """Cross-process OR (the global vote-to-halt)."""
        if self.exchange is None:
            return bool(flag)
        return any(bool(f) for f in self.allgather(tag, bool(flag)))

    def check_consistent(self, tag: str, digest: Any) -> None:
        """Assert all processes present an identical ``digest`` for this
        sequenced point (chunk boundaries, plan fingerprints).  The op
        tag already catches schedule divergence; the digest catches
        same-schedule/different-data divergence (e.g. two processes
        staging differently sized chunks)."""
        views = self.allgather(tag, digest)
        if any(v != digest for v in views):
            raise ExchangeError(
                f"cluster divergence at {tag!r}: {views!r}")

    def barrier(self, tag: str = "barrier") -> None:
        if self.exchange is not None:
            self.exchange.barrier(tag)

    def close(self) -> None:
        if self.exchange is not None:
            self.exchange.close()
        if self.dist_initialized:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            self.dist_initialized = False

    def __enter__(self) -> "ClusterRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _parse_hostport(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def _init_torch_dist(coordinator: str, num_processes: int, process_id: int,
                     timeout: float) -> None:
    """Join the ``gloo`` process group at ``tcp://coordinator``: the
    control plane only (ranks and a store).  NCCL would be the data
    plane, and cannot put two ranks on one device."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))


def init_cluster(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    transport: Optional[str] = None,
    timeout: float = 120.0,
) -> ClusterRuntime:
    """Boot this process's cluster runtime.

    Parameters default from the ``GOFFISH_*`` environment (what
    ``launch/cluster_graph.py`` sets for each spawned worker); with no
    configuration at all this is the single-process no-op fallback.

    ``transport``:

    * ``"tcp"`` — stand up only the :class:`TcpExchange` (the host lane:
      CPU clusters, tests, several processes on one card).
    * ``"torch"`` — additionally join ``torch.distributed`` with the
      ``gloo`` backend at ``coordinator`` (every process gets its rank
      and the group's store).  The host-lane exchange then rides the TCP
      port ``coordinator.port + 1``.
    * ``None``/``"auto"`` — ``"torch"`` when ``torch.distributed`` is
      available, falling back to ``"tcp"`` if its initialization fails.

    >>> init_cluster(num_processes=1).is_distributed
    False
    """
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PROCESS_ID, "0"))
    transport = transport or os.environ.get(ENV_TRANSPORT) or "auto"
    assert transport in TRANSPORTS, \
        f"unknown transport {transport!r}; pick from {TRANSPORTS}"
    if num_processes <= 1:
        return ClusterRuntime(0, 1)
    assert coordinator, "multi-process runs need a coordinator host:port"
    host, port = _parse_hostport(coordinator)

    dist_ok = False
    if transport in ("torch", "auto"):
        try:
            import torch.distributed as dist

            if not dist.is_available():
                raise RuntimeError("torch.distributed is not available")
            _init_torch_dist(coordinator, num_processes, process_id,
                             timeout)
            dist_ok = True
        except Exception:
            if transport == "torch":
                raise
    # the host-lane exchange always exists: the boundary fold, the halt
    # vote, and the staging consistency checks ride it even when
    # torch.distributed is up (they are host-side numpy operations)
    ex_port = port + 1 if dist_ok else port
    if process_id == 0:
        ex = TcpExchange.listen(ex_port, num_processes, timeout=timeout)
    else:
        ex = TcpExchange.connect(host, ex_port, process_id, num_processes,
                                 timeout=timeout, retry_for=timeout)
    rt = ClusterRuntime(process_id, num_processes, ex,
                        dist_initialized=dist_ok)
    rt.barrier("init")
    return rt
