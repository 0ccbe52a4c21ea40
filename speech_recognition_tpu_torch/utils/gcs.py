"""A minimal Google Cloud Storage client for gs:// paths (stdlib only): the
port's copy of speech_recognition_tpu/utils/gcs.py.

The JSON API over ``urllib``, covering what :mod:`.io` needs: read, write,
list (glob), stat (exists), copy, with a GFile-like file object.

Auth resolution, in order:
  1. ``STORAGE_EMULATOR_HOST``: anonymous, points at an emulator.
  2. ``GCS_OAUTH_TOKEN``: an explicit bearer token.
  3. The GCE metadata server.
  4. Application-default-credentials JSON (``GOOGLE_APPLICATION_CREDENTIALS``
     or the gcloud well-known file): an authorized user's refresh token, or
     a service-account key when ``cryptography`` is importable.
"""

import io as _io
import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import List, Optional, Tuple

_API = "https://storage.googleapis.com"
_METADATA_TOKEN_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/"
    "service-accounts/default/token"
)
_token_cache = {"token": None, "expiry": 0.0, "failed_until": 0.0}


def _endpoint() -> str:
    host = os.environ.get("STORAGE_EMULATOR_HOST")
    if host:
        return host if "://" in host else f"http://{host}"
    return _API


def _anonymous() -> bool:
    return bool(os.environ.get("STORAGE_EMULATOR_HOST"))


def _adc_path() -> Optional[str]:
    path = os.environ.get("GOOGLE_APPLICATION_CREDENTIALS")
    if path and os.path.exists(path):
        return path
    well_known = os.path.join(
        os.path.expanduser("~"), ".config", "gcloud", "application_default_credentials.json"
    )
    return well_known if os.path.exists(well_known) else None


def _refresh_authorized_user(info: dict) -> Optional[Tuple[str, float]]:
    body = urllib.parse.urlencode(
        {
            "grant_type": "refresh_token",
            "client_id": info["client_id"],
            "client_secret": info["client_secret"],
            "refresh_token": info["refresh_token"],
        }
    ).encode()
    req = urllib.request.Request(
        info.get("token_uri", "https://oauth2.googleapis.com/token"), data=body, method="POST"
    )
    req.add_header("Content-Type", "application/x-www-form-urlencoded")
    with urllib.request.urlopen(req, timeout=30) as resp:
        payload = json.load(resp)
    return payload["access_token"], time.time() + float(payload.get("expires_in", 3600))


def _refresh_service_account(info: dict) -> Optional[Tuple[str, float]]:
    try:  # RS256 JWT signing requires a crypto backend
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import padding
    except Exception:
        return None
    import base64

    b64 = lambda b: base64.urlsafe_b64encode(b).rstrip(b"=")
    now = int(time.time())
    header = b64(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
    claims = b64(
        json.dumps(
            {
                "iss": info["client_email"],
                "scope": "https://www.googleapis.com/auth/devstorage.read_write",
                "aud": info.get("token_uri", "https://oauth2.googleapis.com/token"),
                "iat": now,
                "exp": now + 3600,
            }
        ).encode()
    )
    signing_input = header + b"." + claims
    key = serialization.load_pem_private_key(info["private_key"].encode(), password=None)
    signature = key.sign(signing_input, padding.PKCS1v15(), hashes.SHA256())
    assertion = (signing_input + b"." + b64(signature)).decode()
    body = urllib.parse.urlencode(
        {"grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer", "assertion": assertion}
    ).encode()
    req = urllib.request.Request(
        info.get("token_uri", "https://oauth2.googleapis.com/token"), data=body, method="POST"
    )
    req.add_header("Content-Type", "application/x-www-form-urlencoded")
    with urllib.request.urlopen(req, timeout=30) as resp:
        payload = json.load(resp)
    return payload["access_token"], time.time() + float(payload.get("expires_in", 3600))


def _fetch_token() -> Optional[Tuple[str, float]]:
    env = os.environ.get("GCS_OAUTH_TOKEN")
    if env:
        return env, time.time() + 3600
    # metadata server (TPU VM / GCE)
    try:
        req = urllib.request.Request(_METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"})
        with urllib.request.urlopen(req, timeout=2) as resp:
            payload = json.load(resp)
        return payload["access_token"], time.time() + float(payload.get("expires_in", 3600))
    except Exception:
        pass
    adc = _adc_path()
    if adc:
        try:
            with open(adc) as f:
                info = json.load(f)
            if info.get("type") == "authorized_user":
                return _refresh_authorized_user(info)
            if info.get("type") == "service_account":
                return _refresh_service_account(info)
        except Exception:
            return None
    return None


def available() -> bool:
    """True when this client can authenticate (or an emulator is set).
    Failed credential discovery is cached for 5 min, so that a caller does
    not pay the metadata-server probe on every call."""
    if _anonymous():
        return True
    now = time.time()
    if _token_cache["token"] and _token_cache["expiry"] - 60 > now:
        return True
    if now < _token_cache["failed_until"]:
        return False
    got = _fetch_token()
    if got:
        _token_cache["token"], _token_cache["expiry"] = got
        return True
    _token_cache["failed_until"] = now + 300
    return False


def _auth_header() -> dict:
    if _anonymous():
        return {}
    if not available():
        raise NotImplementedError(
            "no GCS credentials found (tried STORAGE_EMULATOR_HOST, GCS_OAUTH_TOKEN, "
            "metadata server, application default credentials)"
        )
    return {"Authorization": f"Bearer {_token_cache['token']}"}


def _split(path: str) -> Tuple[str, str]:
    if not path.startswith("gs://"):
        raise ValueError(f"not a gs:// path: {path}")
    rest = path[len("gs://"):]
    bucket, _, obj = rest.partition("/")
    return bucket, obj


def _request(url: str, data=None, method="GET", headers=None):
    req = urllib.request.Request(url, data=data, method=method)
    for k, v in {**_auth_header(), **(headers or {})}.items():
        req.add_header(k, v)
    return urllib.request.urlopen(req, timeout=60)


def _quote(obj: str) -> str:
    return urllib.parse.quote(obj, safe="")


def read_bytes(path: str) -> bytes:
    bucket, obj = _split(path)
    url = f"{_endpoint()}/storage/v1/b/{bucket}/o/{_quote(obj)}?alt=media"
    try:
        with _request(url) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        if e.code == 404:
            raise FileNotFoundError(path) from e
        raise


def write_bytes(path: str, data: bytes) -> None:
    bucket, obj = _split(path)
    url = (
        f"{_endpoint()}/upload/storage/v1/b/{bucket}/o"
        f"?uploadType=media&name={_quote(obj)}"
    )
    with _request(url, data=data, method="POST",
                  headers={"Content-Type": "application/octet-stream"}) as resp:
        resp.read()


def list_objects_meta(bucket: str, prefix: str) -> List[dict]:
    """All objects under ``prefix`` with their JSON-API metadata (name, and,
    when the server provides it, the ``updated`` RFC3339 timestamp)."""
    items, page_token = [], None
    while True:
        qs = {"prefix": prefix}
        if page_token:
            qs["pageToken"] = page_token
        url = f"{_endpoint()}/storage/v1/b/{bucket}/o?{urllib.parse.urlencode(qs)}"
        with _request(url) as resp:
            payload = json.load(resp)
        items += payload.get("items", [])
        page_token = payload.get("nextPageToken")
        if not page_token:
            return items


def list_objects(bucket: str, prefix: str) -> List[str]:
    """The names of all objects under ``prefix``."""
    return [item["name"] for item in list_objects_meta(bucket, prefix)]


def parse_rfc3339(ts: str) -> float:
    """RFC3339 ('2024-01-02T03:04:05.678Z') -> epoch seconds; 0.0 if absent."""
    if not ts:
        return 0.0
    import datetime

    try:
        return datetime.datetime.fromisoformat(ts.replace("Z", "+00:00")).timestamp()
    except ValueError:
        return 0.0


def _glob_regex(pattern: str):
    """gfile glob semantics: * and ? do not cross '/' separators."""
    import re

    out = []
    for ch in pattern:
        if ch == "*":
            out.append("[^/]*")
        elif ch == "?":
            out.append("[^/]")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out) + r"\Z")


def glob(pattern: str) -> List[str]:
    bucket, obj_pattern = _split(pattern)
    prefix = obj_pattern.split("*", 1)[0].split("?", 1)[0].split("[", 1)[0]
    rx = _glob_regex(obj_pattern)
    matches = [
        f"gs://{bucket}/{name}"
        for name in list_objects(bucket, prefix)
        if rx.match(name)
    ]
    return sorted(matches)


def exists(path: str) -> bool:
    bucket, obj = _split(path)
    if not obj:
        return True
    url = f"{_endpoint()}/storage/v1/b/{bucket}/o/{_quote(obj)}"
    try:
        with _request(url) as resp:
            resp.read()
        return True
    except urllib.error.HTTPError as e:
        if e.code == 404:
            # gfile treats a "directory" (any object under the prefix) as existing
            return bool(list_objects(bucket, obj.rstrip("/") + "/"))
        raise


def copy(src: str, dst: str, overwrite: bool = True) -> None:
    if not overwrite and exists(dst):
        raise FileExistsError(dst)
    if src.startswith("gs://") and dst.startswith("gs://"):
        sb, so = _split(src)
        db, do = _split(dst)
        url = (
            f"{_endpoint()}/storage/v1/b/{sb}/o/{_quote(so)}"
            f"/copyTo/b/{db}/o/{_quote(do)}"
        )
        with _request(url, data=b"", method="POST") as resp:
            resp.read()
    elif src.startswith("gs://"):
        with open(dst, "wb") as f:
            f.write(read_bytes(src))
    else:
        with open(src, "rb") as f:
            write_bytes(dst, f.read())


def makedirs(path: str) -> None:
    """GCS has no directories; parity with gfile's empty marker object."""
    bucket, obj = _split(path)
    if obj:
        write_bytes(f"gs://{bucket}/{obj.rstrip('/')}/", b"")


class GFile:
    """File object over read_bytes/write_bytes (the surface of ``open``'s result that io.py's callers use)."""

    def __init__(self, path: str, mode: str = "r"):
        self._path = path
        self._mode = mode
        binary = "b" in mode
        if "w" in mode or "a" in mode:
            if "a" in mode and exists(path):
                initial = read_bytes(path)
            else:
                initial = b""
            self._buf = _io.BytesIO(initial) if binary else _io.StringIO(
                initial.decode("utf-8")
            )
            self._buf.seek(0, 2)
            self._writable = True
        else:
            data = read_bytes(path)
            self._buf = _io.BytesIO(data) if binary else _io.StringIO(data.decode("utf-8"))
            self._writable = False

    def read(self, *a):
        return self._buf.read(*a)

    def readline(self, *a):
        return self._buf.readline(*a)

    def write(self, data):
        return self._buf.write(data)

    def seek(self, *a):
        return self._buf.seek(*a)

    def tell(self):
        return self._buf.tell()

    def __iter__(self):
        return iter(self._buf)

    def flush(self):
        pass

    def close(self):
        if self._writable:
            value = self._buf.getvalue()
            write_bytes(self._path, value if isinstance(value, bytes) else value.encode("utf-8"))
            self._writable = False
        self._buf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
