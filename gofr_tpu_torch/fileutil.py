"""In-memory zip archives of multipart uploads — counterpart of
``gofr_tpu/fileutil.py``. A handler declares a dataclass field as ``Zip``
and the multipart binder hands it the parsed archive: ``files`` maps each
entry's name to its bytes, and ``create_local_copies`` writes them under a
directory, refusing any entry whose path leaves it."""

from __future__ import annotations

import io
import os
import zipfile

__all__ = ["Zip"]


class Zip:
    """A zip archive parsed from uploaded bytes."""

    def __init__(self, content: bytes) -> None:
        self.files: dict[str, bytes] = {}
        with zipfile.ZipFile(io.BytesIO(content)) as zf:
            for info in zf.infolist():
                if info.is_dir():
                    continue
                self.files[info.filename] = zf.read(info)

    @classmethod
    def from_bytes(cls, content: bytes) -> "Zip":
        return cls(content)

    def create_local_copies(self, dest_dir: str) -> list[str]:
        """Extract every entry under ``dest_dir``; raises ``ValueError``
        on an entry that would land outside it."""
        written = []
        root = os.path.abspath(dest_dir)
        for name, data in self.files.items():
            target = os.path.abspath(os.path.join(root, name))
            if not target.startswith(root + os.sep):
                raise ValueError(f"zip entry escapes destination: {name!r}")
            os.makedirs(os.path.dirname(target), exist_ok=True)
            with open(target, "wb") as fh:
                fh.write(data)
            written.append(target)
        return written
