"""The HTTP layer of the port's serving front: typed errors
(``errors.py``), the request adapter (``request.py``), the JSON envelope
(``responder.py``), the raw ``File`` result (``response.py``) and the
middleware chain (``middleware.py``) — counterparts of ``gofr_tpu/http``,
cut to what the front runs."""
