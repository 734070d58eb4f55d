"""Multipart file binding on the port — counterpart of
``examples/using_file_bind/main.py``: ``POST /upload`` binds a form to a
dataclass whose ``Zip`` field (the form's ``hello`` part) arrives parsed,
and ``POST /upload-meta`` binds the same part as an ``UploadedFile`` with
its name, content type and size.

    python -m gofr_tpu_torch.examples.using_file_bind
"""

from __future__ import annotations

import dataclasses

from ..app import App, new_app
from ..context import Context
from ..fileutil import Zip
from ..http.errors import MissingParam
from ..http.request import UploadedFile

__all__ = ["UploadData", "RawUpload", "main"]


@dataclasses.dataclass
class UploadData:
    name: str = ""
    # the form field is called "hello"; bind it here as a parsed zip
    archive: Zip | None = dataclasses.field(default=None,
                                            metadata={"file": "hello"})


@dataclasses.dataclass
class RawUpload:
    hello: UploadedFile | None = None


async def upload(ctx: Context):
    data = await ctx.bind(UploadData)
    out = {"name": data.name}
    if data.archive is not None:
        out["zip_entries"] = sorted(data.archive.files)
    return out


async def upload_meta(ctx: Context):
    f = (await ctx.bind(RawUpload)).hello
    if f is None:
        raise MissingParam("hello")
    return {"filename": f.filename, "content_type": f.content_type,
            "size": f.size}


def main() -> App:
    app = new_app()
    app.post("/upload", upload)
    app.post("/upload-meta", upload_meta)
    return app


if __name__ == "__main__":
    main().run()
