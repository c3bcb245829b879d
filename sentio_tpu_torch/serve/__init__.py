"""The HTTP serving surface: schemas, handlers and the server
(``python -m sentio_tpu_torch serve``)."""
