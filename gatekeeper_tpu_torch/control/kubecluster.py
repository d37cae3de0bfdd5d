# Copied from gatekeeper_tpu/control/kubecluster.py; only these edits differ.
# Edit: `subscribe` keeps the EventSource contract (events from now on):
# its first List runs synchronously and emits nothing (`_Watcher.prime`).
# The reference's watcher emitted ADDED for every listed object on top of
# the WatchManager's own List, so each synced object was ingested twice,
# and the Config was reconciled twice, wiping the synced data while it
# was being ingested (ROADMAP §C).
"""Real-apiserver EventSource: list+watch over the Kubernetes HTTP API.

The reference's entire control plane runs against a live apiserver via
client-go informers (pkg/watch/manager.go:280-348, forked dynamiccache
third_party/.../dynamiccache/informer_cache.go:168, manager wiring
main.go:136-146). `KubeCluster` is this framework's native equivalent of
that stack behind the same `EventSource` seam the FakeCluster implements,
so the Runner, controllers, status plane, and audit run UNCHANGED against
a real cluster:

  * discovery — /api/v1 + /apis group lists map GVK -> REST path
    (plural, namespaced) and enumerate listable kinds (the audit
    manager's ServerPreferredResources analog, audit/manager.go:244-272);
  * list/get — plain GETs, with apiVersion/kind re-stamped onto items
    (list responses omit them);
  * subscribe — a watch thread per subscription: chunked
    ?watch=1&allowWatchBookmarks=true streams decoded line-by-line, with
    informer-style RELIST-AND-DIFF recovery on stream errors/410 Gone
    (synthetic ADDED/MODIFIED/DELETED from the per-subscription cache,
    then re-watch from the fresh resourceVersion);
  * apply/delete — POST, falling back to read-modify-PUT on conflict
    (the status plane's CR writes, audit/manager.go:581-639).

Pure stdlib (urllib + ssl): in-cluster config from the service-account
mount, or explicit base_url/token/ca for tests and kubeconfig-less use.
"""

from __future__ import annotations

import json
import os
import ssl
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..logs import null_logger
from .events import (
    ADDED,
    Conflict,
    DELETED,
    Event,
    EventSink,
    EventSource,
    GVK,
    MODIFIED,
    obj_key,
)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeError(Exception):
    def __init__(self, code: int, body: str):
        super().__init__(f"apiserver {code}: {body[:200]}")
        self.code = code
        self.body = body


class KubeCluster(EventSource):
    def __init__(
        self,
        base_url: Optional[str] = None,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        verify: bool = True,
        watch_timeout_seconds: int = 300,
        logger=None,
    ):
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise KubeError(0, "no base_url and not running in-cluster")
            base_url = f"https://{host}:{port}"
            if token is None and os.path.exists(f"{SA_DIR}/token"):
                with open(f"{SA_DIR}/token") as f:
                    token = f.read().strip()
            if ca_file is None and os.path.exists(f"{SA_DIR}/ca.crt"):
                ca_file = f"{SA_DIR}/ca.crt"
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.watch_timeout_seconds = watch_timeout_seconds
        self.log = logger if logger is not None else null_logger()
        self._ctx: Optional[ssl.SSLContext] = None
        if self.base_url.startswith("https"):
            self._ctx = ssl.create_default_context(cafile=ca_file)
            if not verify:
                self._ctx.check_hostname = False
                self._ctx.verify_mode = ssl.CERT_NONE
        self._lock = threading.Lock()
        # GVK -> (plural, namespaced); None = not served
        self._rest_info: Dict[GVK, Optional[Tuple[str, bool]]] = {}
        self._stopping = threading.Event()
        self._watchers: List["_Watcher"] = []

    # -- HTTP ----------------------------------------------------------------

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        timeout: float = 30.0,
        stream: bool = False,
    ):
        url = self.base_url + path
        data = None
        headers = {"Accept": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(
            url, data=data, method=method, headers=headers
        )
        try:
            resp = urllib.request.urlopen(
                req, timeout=timeout, context=self._ctx
            )
        except urllib.error.HTTPError as e:
            raise KubeError(e.code, e.read().decode(errors="replace"))
        except urllib.error.URLError as e:
            raise KubeError(0, str(e.reason))
        if stream:
            return resp
        with resp:
            return json.loads(resp.read() or b"{}")

    # -- discovery -----------------------------------------------------------

    def _gvk_path(self, gvk: GVK) -> Tuple[str, bool]:
        """-> (collection path prefix, namespaced)."""
        info = self._discover(gvk)
        if info is None:
            raise KubeError(404, f"kind not served: {gvk}")
        plural, namespaced = info
        if gvk.group:
            return f"/apis/{gvk.group}/{gvk.version}/{plural}", namespaced
        return f"/api/{gvk.version}/{plural}", namespaced

    def _discover(self, gvk: GVK) -> Optional[Tuple[str, bool]]:
        with self._lock:
            if gvk in self._rest_info:
                return self._rest_info[gvk]
        base = (
            f"/apis/{gvk.group}/{gvk.version}"
            if gvk.group
            else f"/api/{gvk.version}"
        )
        info: Optional[Tuple[str, bool]] = None
        try:
            rl = self._request("GET", base)
            for r in rl.get("resources", []):
                if r.get("kind") == gvk.kind and "/" not in r.get("name", ""):
                    info = (r["name"], bool(r.get("namespaced")))
                    break
        except KubeError as e:
            if e.code not in (403, 404):
                raise
        # cache POSITIVE results only: a constraint kind's CRD may be
        # established moments after the template ingests, and a cached
        # None would make the watcher's retry loop re-read a stale miss
        # forever (the kind would silently never be enforced)
        if info is not None:
            with self._lock:
                self._rest_info[gvk] = info
        return info

    def known_gvks(self) -> List[GVK]:
        """Every list+watchable kind the server discovers (the audit
        manager's direct-list sweep source; manager.go:244-272)."""
        out: List[GVK] = []
        try:
            core = self._request("GET", "/api/v1")
            for r in core.get("resources", []):
                verbs = set(r.get("verbs") or [])
                if "/" in r.get("name", "") or "list" not in verbs:
                    continue
                out.append(GVK("", "v1", r["kind"]))
        except KubeError:
            pass
        try:
            groups = self._request("GET", "/apis")
            for g in groups.get("groups", []):
                pref = (g.get("preferredVersion") or {}).get("groupVersion")
                if not pref:
                    continue
                try:
                    rl = self._request("GET", f"/apis/{pref}")
                except KubeError:
                    continue
                grp, _, ver = pref.partition("/")
                for r in rl.get("resources", []):
                    verbs = set(r.get("verbs") or [])
                    if "/" in r.get("name", "") or "list" not in verbs:
                        continue
                    out.append(GVK(grp, ver, r["kind"]))
        except KubeError:
            pass
        return out

    # -- reads ---------------------------------------------------------------

    # page size for chunked Lists (the reference's --audit-chunk-size
    # posture, audit/manager.go:50,280-334: big clusters must not be
    # fetched as one giant response)
    list_chunk_size = 500

    def _pages(self, gvk: GVK, limit: int):
        """The limit/continue pagination protocol, shared by list() and
        list_pages(): yields (items, list metadata) per page with
        apiVersion/kind restamped on every item."""
        path, _ = self._gvk_path(gvk)
        cont = ""
        while True:
            qs = f"?limit={limit}"
            if cont:
                from urllib.parse import quote

                qs += f"&continue={quote(cont)}"
            doc = self._request("GET", path + qs)
            items = doc.get("items") or []
            for it in items:
                it.setdefault("apiVersion", gvk.api_version)
                it.setdefault("kind", gvk.kind)
            meta = doc.get("metadata") or {}
            yield items, meta
            cont = meta.get("continue") or ""
            if not cont:
                return

    def _list_raw(self, gvk: GVK) -> Tuple[List[Dict[str, Any]], str]:
        items: List[Dict[str, Any]] = []
        rv = ""
        for page, meta in self._pages(gvk, self.list_chunk_size):
            items.extend(page)
            rv = meta.get("resourceVersion", rv)
        return items, rv

    def list(self, gvk: GVK) -> List[Dict[str, Any]]:
        try:
            return self._list_raw(gvk)[0]
        except KubeError as e:
            if e.code in (403, 404):
                return []
            raise

    def list_pages(self, gvk: GVK, limit: int):
        """Stream the collection page by page at the given limit —
        bounded memory for huge kinds (the reference's paged audit
        listing, --audit-chunk-size + client.List w/ Continue,
        audit/manager.go:277-298). Yields lists of items.

        A continue token that expires mid-stream (410 ResourceExpired:
        etcd compaction outruns a slow consumer) falls back to ONE full
        relist from scratch, like client-go's pager — the caller sees
        the fresh pages after a RESTART marker of None, so it can drop
        partial per-kind state instead of double-counting."""
        try:
            gen = self._pages(gvk, limit)
            restarted = False
            while True:
                try:
                    items, _meta = next(gen)
                except StopIteration:
                    return
                except KubeError as e:
                    if e.code == 410 and not restarted:
                        restarted = True
                        yield None  # RESTART: discard prior pages
                        gen = self._pages(gvk, limit)
                        continue
                    raise
                if items:
                    yield items
        except KubeError as e:
            if e.code in (403, 404):
                return  # kind not (yet) served
            raise

    def _collection_path(self, gvk: GVK, namespace: str = "") -> str:
        """Collection path, namespaced when the kind is and a namespace
        is given (/api/v1/namespaces/<ns>/pods vs /api/v1/pods)."""
        path, namespaced = self._gvk_path(gvk)
        if namespaced and namespace:
            head, plural = path.rsplit("/", 1)
            return f"{head}/namespaces/{namespace}/{plural}"
        return path

    def get(self, gvk: GVK, namespace: str, name: str) -> Optional[dict]:
        path = self._collection_path(gvk, namespace)
        try:
            obj = self._request("GET", f"{path}/{name}")
        except KubeError as e:
            if e.code == 404:
                return None
            raise
        obj.setdefault("apiVersion", gvk.api_version)
        obj.setdefault("kind", gvk.kind)
        return obj

    # -- watch ---------------------------------------------------------------

    def subscribe(self, gvk: GVK, sink: EventSink) -> Callable[[], None]:
        """Events from now on (the EventSource contract; the caller lists
        the current state itself, as the WatchManager does): the first
        List runs here, before returning, and emits nothing, so an
        object created before the caller's own List is never missed."""
        w = _Watcher(self, gvk, sink)
        w.prime()
        with self._lock:
            self._watchers.append(w)
        w.start()

        def unsubscribe() -> None:
            w.stop()
            with self._lock:
                if w in self._watchers:
                    self._watchers.remove(w)

        return unsubscribe

    def stop(self) -> None:
        self._stopping.set()
        with self._lock:
            watchers = list(self._watchers)
        for w in watchers:
            w.stop()

    # -- writes --------------------------------------------------------------

    def _obj_path(self, obj: Dict[str, Any]) -> str:
        meta = obj.get("metadata") or {}
        return self._collection_path(
            GVK.from_obj(obj), meta.get("namespace") or ""
        )

    def create(self, obj: Dict[str, Any]) -> None:
        """Create-ONLY write: POST, with the apiserver's 409 surfaced as
        `events.Conflict` instead of retried into a replace. The fleet
        cert store's load-or-create depends on losing this race loudly —
        the loser adopts the winner's Secret rather than clobbering it
        (certs.go:119-181's CreateOrUpdate-with-conflict posture)."""
        coll = self._obj_path(obj)
        try:
            self._request("POST", coll, body=obj)
        except KubeError as e:
            if e.code == 409:
                name = (obj.get("metadata") or {}).get("name", "")
                raise Conflict(f"{coll}/{name} already exists") from e
            raise

    def apply(self, obj: Dict[str, Any]) -> None:
        """Create-or-replace (the status plane's write-with-retry,
        audit/manager.go:581-639)."""
        coll = self._obj_path(obj)
        name = (obj.get("metadata") or {}).get("name", "")
        try:
            self._request("POST", coll, body=obj)
            return
        except KubeError as e:
            if e.code != 409:
                raise
        for _ in range(4):
            cur = self._request("GET", f"{coll}/{name}")
            merged = dict(obj)
            meta = dict(obj.get("metadata") or {})
            meta["resourceVersion"] = (cur.get("metadata") or {}).get(
                "resourceVersion", ""
            )
            merged["metadata"] = meta
            try:
                self._request("PUT", f"{coll}/{name}", body=merged)
                return
            except KubeError as e:
                if e.code != 409:
                    raise
        raise KubeError(409, f"persistent conflict updating {name}")

    def delete(self, obj_or_gvk, namespace: str = "", name: str = "") -> bool:
        if isinstance(obj_or_gvk, GVK):
            gvk = obj_or_gvk
            ns = namespace
        else:
            gvk = GVK.from_obj(obj_or_gvk)
            meta = obj_or_gvk.get("metadata") or {}
            ns = meta.get("namespace") or ""
            name = meta.get("name") or ""
        path = self._collection_path(gvk, ns)
        try:
            self._request("DELETE", f"{path}/{name}")
            return True
        except KubeError as e:
            if e.code == 404:
                return False
            raise


class _Watcher:
    """One subscription's watch loop: stream, decode, dispatch; on any
    stream failure relist-and-diff (informer resync) and re-watch."""

    def __init__(self, cluster: KubeCluster, gvk: GVK, sink: EventSink):
        self.cluster = cluster
        self.gvk = gvk
        self.sink = sink
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._known: Dict[Tuple[str, str], str] = {}  # key -> resourceVersion
        self._rv = ""

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def prime(self) -> None:
        """The subscription's first List, without events: it sets the
        resume point and the cache that later relists diff against. A
        kind not served yet leaves both empty, and the loop's first
        relist, once it is served, emits its objects as ADDED (the
        caller's own List found none)."""
        try:
            items, rv = self.cluster._list_raw(self.gvk)
        except KubeError:
            return
        self._known = {
            obj_key(obj): (obj.get("metadata") or {}).get(
                "resourceVersion", "")
            for obj in items
        }
        self._rv = rv

    def _emit(self, etype: str, obj: Dict[str, Any]) -> None:
        obj.setdefault("apiVersion", self.gvk.api_version)
        obj.setdefault("kind", self.gvk.kind)
        try:
            self.sink(Event(etype, self.gvk, obj))
        except Exception as e:
            self.cluster.log.error(
                "watch sink failed", err=e, event_type=etype
            )

    def _resync(self) -> bool:
        """List and reconcile against the subscription cache — the
        informer's replay after a broken/expired watch."""
        try:
            items, rv = self.cluster._list_raw(self.gvk)
        except KubeError as e:
            if e.code in (403, 404):
                return False  # kind (not yet) served: retry later
            self.cluster.log.error("relist failed", err=e, gvk=str(self.gvk))
            return False
        seen: Dict[Tuple[str, str], str] = {}
        for obj in items:
            key = obj_key(obj)
            orv = (obj.get("metadata") or {}).get("resourceVersion", "")
            seen[key] = orv
            old = self._known.get(key)
            if old is None:
                self._emit(ADDED, obj)
            elif old != orv:
                self._emit(MODIFIED, obj)
        for key in list(self._known):
            if key not in seen:
                ns, name = key
                self._emit(
                    DELETED,
                    {
                        "metadata": {
                            "namespace": ns or None,
                            "name": name,
                        }
                    },
                )
        self._known = seen
        self._rv = rv
        return True

    def _loop(self) -> None:
        backoff = 0.2
        while not self._stop.is_set():
            # relist-and-diff only when there is no resume point: first
            # pass, expired/failed stream. A CLEAN server-side close
            # (the default 300s watch timeout) re-watches straight from
            # the last bookmark rv like the reference's informers —
            # relisting there is O(corpus) list traffic per subscription
            # every few minutes (ADVICE r4).
            if not self._rv:
                if not self._resync():
                    self._stop.wait(min(backoff, 30.0))
                    backoff *= 2
                    continue
                backoff = 0.2
            started = time.monotonic()
            try:
                self._watch_once()
                # clean close: normally re-watch immediately (real
                # servers close every few minutes) — but a stream that
                # died in under a second (draining apiserver, proxy
                # dropping long-lived requests) must not busy-loop
                # watch requests; back off until streams live again
                if time.monotonic() - started >= 0.5:
                    backoff = 0.2
                else:
                    self._stop.wait(min(backoff, 30.0))
                    backoff *= 2
            except KubeError as e:
                if e.code == 410:
                    # expired resourceVersion: only this invalidates the
                    # resume point — transient apiserver errors (500s,
                    # failed establishment) keep _rv and re-watch, no
                    # O(corpus) relist
                    self._rv = ""
                else:
                    self.cluster.log.error(
                        "watch failed", err=e, gvk=str(self.gvk)
                    )
                    self._stop.wait(min(backoff, 30.0))
                    backoff *= 2
            except Exception as e:
                # mid-stream break (decode error, socket reset): events
                # may have been lost — relist-and-diff to reconverge
                self._rv = ""
                self.cluster.log.error(
                    "watch stream error", err=e, gvk=str(self.gvk)
                )
                self._stop.wait(min(backoff, 30.0))
                backoff *= 2

    def _watch_once(self) -> None:
        path, _ = self.cluster._gvk_path(self.gvk)
        qs = (
            f"?watch=1&allowWatchBookmarks=true"
            f"&timeoutSeconds={self.cluster.watch_timeout_seconds}"
            f"&resourceVersion={self._rv}"
        )
        resp = self.cluster._request(
            "GET",
            path + qs,
            timeout=self.cluster.watch_timeout_seconds + 15,
            stream=True,
        )
        with resp:
            while not self._stop.is_set():
                line = resp.readline()
                if not line:
                    return  # server closed (timeout): relist+rewatch
                line = line.strip()
                if not line:
                    continue
                ev = json.loads(line)
                etype = ev.get("type")
                obj = ev.get("object") or {}
                if etype == "BOOKMARK":
                    self._rv = (obj.get("metadata") or {}).get(
                        "resourceVersion", self._rv
                    )
                    continue
                if etype == "ERROR":
                    code = obj.get("code", 0)
                    raise KubeError(code or 500, json.dumps(obj))
                if etype not in (ADDED, MODIFIED, DELETED):
                    continue
                key = obj_key(obj)
                rv = (obj.get("metadata") or {}).get("resourceVersion", "")
                if etype == DELETED:
                    self._known.pop(key, None)
                else:
                    self._known[key] = rv
                self._rv = rv or self._rv
                self._emit(etype, obj)
