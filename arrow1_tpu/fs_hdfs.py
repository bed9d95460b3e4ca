"""Native HDFS filesystem over the WebHDFS REST API — no libhdfs/JNI.

Reference: cpp/src/arrow/filesystem/hdfs.cc wraps libhdfs through JNI
(a JVM in-process). That design has no analogue worth keeping here:
Hadoop clusters expose the same namenode/datanode operations over HTTP
(WebHDFS, hdfs-default.xml dfs.webhdfs.enabled=true), so this client
speaks the REST protocol directly with http.client — the same
no-SDK approach as the native S3 filesystem (fs_s3.py).

Operations (WebHDFS v1): GETFILESTATUS, LISTSTATUS, OPEN (with ranged
reads via offset/length), CREATE (two-step redirect to a datanode),
MKDIRS, DELETE. Kerberos/delegation tokens are passed through as query
params when provided; SPNEGO negotiation is out of scope.
"""

from __future__ import annotations

import http.client
import io
import json
import urllib.parse
from typing import List, Optional

from .errors import Invalid
from .fs import FileInfo, FileSystem

__all__ = ["WebHdfsFileSystem"]


class WebHdfsFileSystem(FileSystem):
    def __init__(self, host: str, port: int = 9870, user: str = "hdfs",
                 token: Optional[str] = None, timeout: float = 30.0):
        self.host = host
        self.port = port
        self.user = user
        self.token = token
        self.timeout = timeout

    # ---------------- wire helpers ----------------------------------

    def _url(self, path: str, op: str, **params) -> str:
        if not path.startswith("/"):
            path = "/" + path
        q = {"op": op}
        if self.token:
            q["delegation"] = self.token
        else:
            q["user.name"] = self.user
        q.update({k: str(v) for k, v in params.items() if v is not None})
        return ("/webhdfs/v1" + urllib.parse.quote(path)
                + "?" + urllib.parse.urlencode(q))

    def _request(self, method: str, url: str, body=None,
                 host: Optional[str] = None, port: Optional[int] = None,
                 follow: bool = True):
        conn = http.client.HTTPConnection(host or self.host,
                                          port or self.port,
                                          timeout=self.timeout)
        try:
            conn.request(method, url, body=body)
            resp = conn.getresponse()
            if resp.status in (301, 302, 307) and follow:
                loc = resp.getheader("Location")
                resp.read()
                u = urllib.parse.urlsplit(loc)
                return self._request(
                    method, u.path + ("?" + u.query if u.query else ""),
                    body=body, host=u.hostname, port=u.port,
                    follow=False)
            data = resp.read()
            if resp.status >= 400:
                try:
                    msg = json.loads(data)["RemoteException"]["message"]
                except Exception:
                    msg = data[:200].decode("utf8", "replace")
                if resp.status == 404:
                    raise FileNotFoundError(msg)
                raise Invalid(f"webhdfs {method} {resp.status}: {msg}")
            return data
        finally:
            conn.close()

    # ---------------- FileSystem surface ----------------------------

    def get_file_info(self, path: str) -> FileInfo:
        data = json.loads(self._request(
            "GET", self._url(path, "GETFILESTATUS")))
        st = data["FileStatus"]
        return FileInfo(path, st["type"] == "FILE", st.get("length", 0))

    def ls(self, path: str) -> List[FileInfo]:
        data = json.loads(self._request(
            "GET", self._url(path, "LISTSTATUS")))
        out = []
        base = path.rstrip("/")
        for st in data["FileStatuses"]["FileStatus"]:
            p = f"{base}/{st['pathSuffix']}" if st["pathSuffix"] else base
            out.append(FileInfo(p, st["type"] == "FILE",
                                st.get("length", 0)))
        return out

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        """Ranged read (the dataset scanner's coalesced-fetch unit)."""
        return self._request("GET", self._url(
            path, "OPEN", offset=offset, length=length))

    def open_input(self, path: str):
        return io.BytesIO(self._request("GET", self._url(path, "OPEN")))

    def open_output(self, path: str):
        fs = self

        class _Out(io.BytesIO):
            def close(self):
                data = self.getvalue()
                fs._request("PUT", fs._url(path, "CREATE",
                                           overwrite="true"), body=data)
                super().close()

        return _Out()

    def create_dir(self, path: str):
        self._request("PUT", self._url(path, "MKDIRS"))

    def delete(self, path: str):
        self._request("DELETE", self._url(path, "DELETE",
                                          recursive="true"))
