"""The HTTP layer of the port's framework — counterparts of
``gofr_tpu/http``: typed errors (``errors.py``), the request adapter with
its JSON, form and multipart binders (``request.py``), the response types
(``response.py``) and the JSON envelope (``responder.py``), the
middleware chain with its auth guards (``middleware.py``), RS256 bearer
tokens against a JWKS document (``jwks.py``) and server-sent events
(``sse.py``)."""

from . import errors  # noqa: F401
from .request import HTTPRequest, Request, UploadedFile  # noqa: F401
from .response import File, Raw, Redirect, Response, Template  # noqa: F401
