"""Protobuf wire encoders for the hermetic fakes (the `--wire proto` path).

The native daemon negotiates `application/vnd.kubernetes.protobuf` for the
pods list+watch and a protobuf exposition for Prometheus instant queries
(native/src/proto.cpp — a hand-rolled varint/length-delimited decoder for
the subset of fields the informer, walker and actuator actually read).
For the Python test tiers to exercise that path, the fakes must SERVE
those bytes; this module is the encoding half, field numbers matching the
real k8s.io generated.proto messages:

  runtime.Unknown   magic ``k8s\\0`` + {typeMeta=1{apiVersion=1,kind=2}, raw=2}
  PodList           {metadata=1 ListMeta{resourceVersion=2, continue=3},
                     items=2 repeated Pod}
  Pod               {metadata=1 ObjectMeta, spec=2 PodSpec, status=3 PodStatus}
  ObjectMeta        {name=1, generateName=2, namespace=3, selfLink=4, uid=5,
                     resourceVersion=6, creationTimestamp=8 Time{seconds=1},
                     labels=11 map, annotations=12 map, ownerReferences=13}
  OwnerReference    {kind=1, name=3, uid=4, apiVersion=5, controller=6,
                     blockOwnerDeletion=7}
  PodSpec           {containers=2 repeated Container{name=1, image=2,
                     resources=8 {limits=1 map<,Quantity{string=1}>,
                     requests=2}}, nodeName=10}
  PodStatus         {phase=1, message=3, reason=4}
  WatchEvent        {type=1, object=2 RawExtension{raw=1 = nested Unknown}}

Round-trip contract: the decoder reconstructs EXACTLY the key/value set
the encoder consumed (json::Object is key-sorted, so dumps are identical
regardless of field order) — which is what keeps audit JSONL, capsules
and replay byte-identical across ``--wire`` modes. To guarantee that, the
encoder REFUSES (raises :class:`Unencodable`) any object outside the
schema — unknown keys, empty lists/maps (protobuf cannot encode their
presence), non-string quantities, a creationTimestamp that doesn't
round-trip through ``%Y-%m-%dT%H:%M:%SZ`` — and the fakes fall back to
serving JSON for that response, exactly the negotiation-fallback path a
real JSON-only apiserver exercises.

The Prometheus message is a compact instant-vector exposition
(status=1, errorType=2, error=3, result=4 repeated Series{labels=1
repeated Label{name=1,value=2}, ts_text=2, value_text=3}) carrying the
EXACT decimal text of the JSON form so the native side can reconstruct a
canonical body byte-identical to ``json.dumps`` of the same payload.
"""

from __future__ import annotations

import calendar
import json
import time

K8S_PROTO = "application/vnd.kubernetes.protobuf"
K8S_PROTO_WATCH = K8S_PROTO + ";stream=watch"
PROM_PROTO = "application/x-protobuf"
MAGIC = b"k8s\x00"


class Unencodable(Exception):
    """Object outside the proto schema — the fake must serve JSON."""


def _varint(n: int) -> bytes:
    if n < 0:
        raise Unencodable(f"negative varint {n}")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _ld(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _str(field: int, s) -> bytes:
    if not isinstance(s, str):
        raise Unencodable(f"expected string, got {type(s).__name__}")
    return _ld(field, s.encode())


def _bool(field: int, b) -> bytes:
    if not isinstance(b, bool):
        raise Unencodable(f"expected bool, got {type(b).__name__}")
    return _tag(field, 0) + _varint(1 if b else 0)


def _check_keys(obj: dict, allowed: set, where: str) -> None:
    unknown = set(obj) - allowed
    if unknown:
        raise Unencodable(f"unencodable key(s) in {where}: {sorted(unknown)}")


def _string_map(field: int, m, where: str) -> bytes:
    if not isinstance(m, dict) or not m:
        # protobuf has no presence for an EMPTY map; refusing keeps the
        # decoded key set exact (fallback to JSON instead)
        raise Unencodable(f"{where} must be a non-empty dict")
    out = bytearray()
    for k, v in m.items():
        entry = _str(1, k) + _str(2, v)
        out += _ld(field, entry)
    return bytes(out)


def _quantity_map(field: int, m, where: str) -> bytes:
    if not isinstance(m, dict) or not m:
        raise Unencodable(f"{where} must be a non-empty dict")
    out = bytearray()
    for k, v in m.items():
        entry = _str(1, k) + _ld(2, _str(1, v))  # Quantity{string=1}
        out += _ld(field, entry)
    return bytes(out)


def _time(field: int, rfc3339: str) -> bytes:
    try:
        seconds = calendar.timegm(time.strptime(rfc3339, "%Y-%m-%dT%H:%M:%SZ"))
    except (ValueError, TypeError):
        raise Unencodable(f"timestamp {rfc3339!r} not in %Y-%m-%dT%H:%M:%SZ form") from None
    # the decoder re-renders from seconds; a string that doesn't round-trip
    # (sub-second precision, offsets) would break byte identity
    if time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(seconds)) != rfc3339:
        raise Unencodable(f"timestamp {rfc3339!r} does not round-trip")
    return _ld(field, _tag(1, 0) + _varint(seconds))


def _owner_ref(ref) -> bytes:
    if not isinstance(ref, dict):
        raise Unencodable("ownerReference must be an object")
    _check_keys(ref, {"apiVersion", "kind", "name", "uid", "controller",
                      "blockOwnerDeletion"}, "ownerReference")
    out = bytearray()
    if "kind" in ref:
        out += _str(1, ref["kind"])
    if "name" in ref:
        out += _str(3, ref["name"])
    if "uid" in ref:
        out += _str(4, ref["uid"])
    if "apiVersion" in ref:
        out += _str(5, ref["apiVersion"])
    if "controller" in ref:
        out += _bool(6, ref["controller"])
    if "blockOwnerDeletion" in ref:
        out += _bool(7, ref["blockOwnerDeletion"])
    return bytes(out)


def _object_meta(meta) -> bytes:
    if not isinstance(meta, dict):
        raise Unencodable("metadata must be an object")
    _check_keys(meta, {"name", "generateName", "namespace", "selfLink", "uid",
                       "resourceVersion", "creationTimestamp", "labels",
                       "annotations", "ownerReferences"}, "metadata")
    out = bytearray()
    if "name" in meta:
        out += _str(1, meta["name"])
    if "generateName" in meta:
        out += _str(2, meta["generateName"])
    if "namespace" in meta:
        out += _str(3, meta["namespace"])
    if "selfLink" in meta:
        out += _str(4, meta["selfLink"])
    if "uid" in meta:
        out += _str(5, meta["uid"])
    if "resourceVersion" in meta:
        out += _str(6, meta["resourceVersion"])
    if "creationTimestamp" in meta:
        out += _time(8, meta["creationTimestamp"])
    if "labels" in meta:
        out += _string_map(11, meta["labels"], "metadata.labels")
    if "annotations" in meta:
        out += _string_map(12, meta["annotations"], "metadata.annotations")
    if "ownerReferences" in meta:
        refs = meta["ownerReferences"]
        if not isinstance(refs, list) or not refs:
            raise Unencodable("metadata.ownerReferences must be a non-empty list")
        for ref in refs:
            out += _ld(13, _owner_ref(ref))
    return bytes(out)


def _container(c) -> bytes:
    if not isinstance(c, dict):
        raise Unencodable("container must be an object")
    _check_keys(c, {"name", "image", "resources"}, "container")
    out = bytearray()
    if "name" in c:
        out += _str(1, c["name"])
    if "image" in c:
        out += _str(2, c["image"])
    if "resources" in c:
        res = c["resources"]
        if not isinstance(res, dict):
            raise Unencodable("container.resources must be an object")
        _check_keys(res, {"limits", "requests"}, "resources")
        body = bytearray()
        if "limits" in res:
            body += _quantity_map(1, res["limits"], "resources.limits")
        if "requests" in res:
            body += _quantity_map(2, res["requests"], "resources.requests")
        out += _ld(8, bytes(body))  # zero-length encodes resources: {}
    return bytes(out)


def _pod_spec(spec) -> bytes:
    if not isinstance(spec, dict):
        raise Unencodable("spec must be an object")
    _check_keys(spec, {"containers", "nodeName"}, "spec")
    out = bytearray()
    if "containers" in spec:
        containers = spec["containers"]
        if not isinstance(containers, list) or not containers:
            raise Unencodable("spec.containers must be a non-empty list")
        for c in containers:
            out += _ld(2, _container(c))
    if "nodeName" in spec:
        out += _str(10, spec["nodeName"])
    return bytes(out)


def _pod_status(status) -> bytes:
    if not isinstance(status, dict):
        raise Unencodable("status must be an object")
    _check_keys(status, {"phase", "message", "reason"}, "status")
    out = bytearray()
    if "phase" in status:
        out += _str(1, status["phase"])
    if "message" in status:
        out += _str(3, status["message"])
    if "reason" in status:
        out += _str(4, status["reason"])
    return bytes(out)


def encode_object_body(obj: dict) -> bytes:
    """The bare object message (no Unknown envelope). Raises Unencodable
    for anything outside the Pod-subset schema."""
    if not isinstance(obj, dict):
        raise Unencodable("object must be a dict")
    _check_keys(obj, {"apiVersion", "kind", "metadata", "spec", "status"}, "object")
    out = bytearray()
    if "metadata" in obj:
        out += _ld(1, _object_meta(obj["metadata"]))
    if "spec" in obj:
        out += _ld(2, _pod_spec(obj["spec"]))
    if "status" in obj:
        out += _ld(3, _pod_status(obj["status"]))
    return bytes(out)


def encode_unknown(api_version: str, kind: str, raw: bytes) -> bytes:
    """magic + runtime.Unknown{typeMeta{apiVersion,kind}, raw}."""
    tm = bytearray()
    if api_version:
        tm += _str(1, api_version)
    if kind:
        tm += _str(2, kind)
    return MAGIC + _ld(1, bytes(tm)) + _ld(2, raw)


def encode_pod_list(items: list, meta: dict) -> bytes | None:
    """A whole LIST response (`application/vnd.kubernetes.protobuf`), or
    None when any item falls outside the schema (serve JSON instead).
    ``meta`` is the JSON response's metadata dict (resourceVersion /
    continue)."""
    try:
        body = bytearray()
        lm = bytearray()
        if "resourceVersion" in meta:
            lm += _str(2, meta["resourceVersion"])
        if "continue" in meta:
            lm += _str(3, meta["continue"])
        body += _ld(1, bytes(lm))
        for item in items:
            if item.get("apiVersion") != "v1" or item.get("kind") != "Pod":
                raise Unencodable("proto LIST items must be v1 Pods")
            body += _ld(2, encode_object_body(item))
        return encode_unknown("v1", "PodList", bytes(body))
    except Unencodable:
        return None


def encode_pod_chunk(item: dict) -> bytes | None:
    """One LIST item's length-delimited chunk (PodList field 2), or None
    when the item falls outside the schema. Page-INDEPENDENT — a
    paginated fake encodes each pod once per snapshot rv and assembles
    pages by concatenation (assemble_pod_list)."""
    try:
        if item.get("apiVersion") != "v1" or item.get("kind") != "Pod":
            raise Unencodable("proto LIST items must be v1 Pods")
        return _ld(2, encode_object_body(item))
    except Unencodable:
        return None


def assemble_pod_list(chunks: list, meta: dict) -> bytes | None:
    """Assemble a LIST response from encode_pod_chunk outputs —
    byte-identical to encode_pod_list(items, meta) over the same items.
    None when any chunk was unencodable (serve JSON instead)."""
    if any(c is None for c in chunks):
        return None
    lm = bytearray()
    if "resourceVersion" in meta:
        lm += _str(2, meta["resourceVersion"])
    if "continue" in meta:
        lm += _str(3, meta["continue"])
    return encode_unknown("v1", "PodList", bytes(_ld(1, bytes(lm))) + b"".join(chunks))


def encode_watch_frame(event_type: str, obj: dict) -> bytes | None:
    """One length-prefixed watch frame (4-byte big-endian length + the
    Unknown-wrapped meta/v1 WatchEvent, k8s's LengthDelimitedFramer), or
    None when the object is unencodable."""
    try:
        inner = encode_unknown(obj.get("apiVersion", ""), obj.get("kind", ""),
                               encode_object_body(obj))
        we = _str(1, event_type) + _ld(2, _ld(1, inner))  # RawExtension{raw=1}
        frame = encode_unknown("v1", "WatchEvent", we)
        return len(frame).to_bytes(4, "big") + frame
    except Unencodable:
        return None


# ── Prometheus instant-vector exposition ────────────────────────────────


def encode_prom_vector(payload: dict) -> bytes | None:
    """Encode a `{"status": "success", "data": {"resultType": "vector",
    "result": [...]}}` payload, carrying each sample's timestamp and
    value as their EXACT JSON decimal text, or None when the payload has
    any shape the schema can't round-trip (serve JSON instead)."""
    try:
        if set(payload) != {"status", "data"} or payload["status"] != "success":
            raise Unencodable("only success vector payloads are encodable")
        data = payload["data"]
        if set(data) != {"resultType", "result"} or data["resultType"] != "vector":
            raise Unencodable("only instant vectors are encodable")
        out = bytearray()
        out += _str(1, "success")
        for series in data["result"]:
            if set(series) != {"metric", "value"}:
                raise Unencodable("series must be {metric, value}")
            labels = series["metric"]
            ts, value = series["value"]
            if not isinstance(value, str):
                raise Unencodable("sample value must be a string")
            body = bytearray()
            for name, lv in labels.items():
                body += _ld(1, _str(1, name) + _str(2, lv))
            body += _str(2, json.dumps(ts))  # verbatim JSON number text
            body += _str(3, value)
            out += _ld(4, bytes(body))
        return bytes(out)
    except (Unencodable, KeyError, TypeError, ValueError):
        return None
