"""Metadata + ACL service (≙ the OMERO backbone event-bus services).

The reference fetches ``Pixels`` metadata and read-ACL decisions from the
OMERO server JVM over the clustered event bus (addresses
``omero.get_pixels_description`` / ``omero.can_read``;
``ImageRegionRequestHandler.java:80-84, 316-427``).  Here both are async
calls on a local filesystem-backed service over the chunked-store layout.

ACL model: each image directory may carry an ``acl.json`` —
``{"public": true}`` or ``{"sessions": ["key", ...]}``.  Absent file =
public (the standalone dev posture).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..models.pixels import Pixels


def _check_acl(path: str, session_key: Optional[str]) -> bool:
    acl_file = os.path.join(path, "acl.json")
    if not os.path.exists(acl_file):
        return True
    with open(acl_file) as f:
        acl = json.load(f)
    if acl.get("public"):
        return True
    return session_key is not None and session_key in acl.get("sessions", [])


class LocalMetadataService:
    """Filesystem-backed metadata: ``<data_dir>/<image_id>/meta.json``."""

    def __init__(self, data_dir: str):
        self.data_dir = data_dir

    def _image_dir(self, image_id: int) -> str:
        return os.path.join(self.data_dir, str(image_id))

    async def get_pixels_description(self, image_id: int,
                                     session_key: Optional[str]
                                     ) -> Optional[Pixels]:
        meta_path = os.path.join(self._image_dir(image_id), "meta.json")
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            m = json.load(f)
        return Pixels(
            image_id=image_id,
            pixels_type=m.get("pixels_type", m["dtype"]),
            size_x=m["levels"][0]["size_x"],
            size_y=m["levels"][0]["size_y"],
            size_z=m["size_z"],
            size_c=m["size_c"],
            size_t=m["size_t"],
        )

    async def can_read(self, object_type: str, object_id: int,
                       session_key: Optional[str]) -> bool:
        if object_type != "Image":
            return False
        path = self._image_dir(object_id)
        if not os.path.exists(path):
            return False
        return _check_acl(path, session_key)
