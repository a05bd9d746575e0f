"""Offline stand-ins for the data-acquisition clients' services.

``FakeKowalski`` replays alert packets (made by ``alert_packet``) by object
and programid, with their cutouts in the bson ``$binary`` form Kowalski's
JSON answers carry, and answers the aux catalog's previous candidates.
``FritzSession`` answers the BTS Sample Explorer's CSV queries, Fritz's
paginated candidates endpoint (with an out-of-range answer above its page
size) and its sources endpoint; ``SurveySession`` answers the PanSTARRS
file-list and cutout services and the Legacy Survey cutout service with PNG
images.  Both are module-level and picklable, so a spawned process pool can
use them.  Nothing here opens a socket.
"""

import base64
import gzip
import io
import json

import numpy as np

from btsbot_tpu_torch.data.fits import write_fits_image

CANDIDATE = {"candid": 0, "programid": 1, "fid": 1, "isdiffpos": "t", "jd": 0.0,
             "magpsf": 18.0, "sigmapsf": 0.1, "ndethist": 3, "ncovhist": 9,
             "jdstarthist": 0.0, "sgscore1": 0.5, "sgscore2": -1.0, "drb": 0.9}


def stamp_blob(data: np.ndarray) -> bytes:
    """A gzip-compressed FITS stamp, as ZTF's stampData."""
    return gzip.compress(write_fits_image(data.astype(np.float32)))


def alert_packet(seed, objid="ZTF21aaaaaaa", size=63, **candidate):
    rng = np.random.default_rng(seed)
    packet = {"objectId": objid, "candidate": {**CANDIDATE, **candidate},
              "classifications": {"acai_h": float(rng.uniform())}}
    for key in ("Science", "Template", "Difference"):
        packet[f"cutout{key}"] = {"stampData": stamp_blob(rng.normal(size=(size, size)))}
    return packet


def _b64(blob: bytes):
    return {"$binary": {"base64": base64.b64encode(blob).decode(), "subType": "00"}}


class FakeKowalski:
    """Replays packets by object and programid; aux catalog from a dict."""

    def __init__(self, packets, prv=None):
        self.packets, self.prv, self.calls = packets, prv or {}, 0

    def query(self, q):
        self.calls += 1
        flt = q["query"]["filter"]
        if q["query"]["catalog"] == "ZTF_alerts":
            data = [json.loads(json.dumps(p, default=_b64)) for p in
                    self.packets.get(flt["objectId"], [])
                    if p["candidate"]["programid"] == flt["candidate.programid"]]
        else:
            data = [{"prv_candidates": self.prv[flt["_id"]]}] if flt["_id"] in self.prv else []
        return {"kowalski": {"data": data}}


class Response:
    def __init__(self, text="", content=b"", ok=True):
        self.text, self.content, self.ok = text, content, ok

    def json(self):
        return json.loads(self.text)


_BTSSE = {
    "trans": ("ZTFID,IAUID,peakmag,type,redshift\n"
              "ZTF21aaa,SN 2021a,17.9,SN Ia,0.03\n"
              "ZTF21aab,SN 2021b,18.2,SN II,\n"
              "ZTF21aac,,18.4,duplicate,0.05\n"
              "ZTF18abdiasx,SN 2018x,18.1,SN Ia,0.02\n"
              "ZTF21aad,\"SN 2021d, late\",18.3,SN Ib,0.04\n"),
    "var": ("ZTFID,IAUID,peakmag,type,redshift\n"
            "ZTF21aaa,SN 2021a,17.9,SN Ia,0.03\n"
            "ZTF19var,,16.5,varstar,\n"
            "ZTF19vbr,,17.25,CV,\n"),
    "all": ("ZTFID,IAUID,peakmag,type,redshift\n"
            "ZTF20dim,SN 2020a,18.9,SN Ia,0.1\n"
            "ZTF20dio,,19.1,duplicate?,\n"
            "ZTF19vbr,,17.25,CV,\n"
            "ZTF20dip,SN 2020c,19.4,AGN,0.2\n"),
}
_SAVED = {"ZTF21aaa": "2021-03-04T05:06:07.123", "ZTF21aad": "2021-06-01T00:00:00"}


class FritzSession:
    def __init__(self, page: int = 250, n_rejects: int = 7):
        self.page = page
        self.rejects = [f"ZTF21rej{i:04d}" for i in range(n_rejects)] + ["ZTF21aaa"]

    def get(self, url, params=None, auth=None, headers=None):
        params = params or {}
        if "explorer" in url:
            return Response(_BTSSE[params["subsample"]])
        if url.endswith("/api/candidates"):
            per, page = params["numPerPage"], params["pageNumber"]
            if per > self.page:
                return Response("Page number out of range.")
            ids = self.rejects[(page - 1) * per:page * per]
            return Response(json.dumps({"data": {"candidates": [{"id": i} for i in ids]}}))
        objid = url.rsplit("/", 1)[-1]
        if objid == "ZTF21aab":
            return Response("{}", ok=False)
        if objid not in _SAVED:
            return Response(json.dumps({"data": {"groups": [
                {"name": "RCF Junk", "saved_at": "2021-01-01T00:00:00"}]}}))
        return Response(json.dumps({"data": {"groups": [
            {"name": "Redshift Completeness Factor", "saved_at": _SAVED[objid]}]}}))


def _png(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr.astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


class SurveySession:
    def __init__(self, bands: str = "grizy"):
        self.bands = bands

    def get(self, url, params=None, **_):
        params = params or {}
        if "ps1filenames" in url:
            lines = ["projcell subcell ra dec filter mjd type filename shortname badflag"]
            for b in self.bands[::-1]:
                lines.append(f"2381 35 10.0 20.0 {b} 0 stack /rings/{b}.fits {b}.fits 0")
            return Response("\n".join(lines))
        if "fitscut" in url:
            rng = np.random.default_rng(len(url))
            return Response(content=_png(rng.integers(0, 256, size=(252, 252, 3))))
        ra = float(params["ra"])
        if ra == 3.0:
            raise ConnectionError("stub: no route to the service")
        if ra == 4.0:
            return Response(content=_png(np.full((63, 63, 3), 32)))
        rng = np.random.default_rng(int(ra * 100))
        return Response(content=_png(rng.integers(0, 256, size=(63, 63, 3))))
