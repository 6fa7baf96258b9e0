"""Serving: the LM path's RE-constrained decode engine and continuous batcher
(``engine``, ``scheduler``), and the parser's request and stream services
(``parse_service``, ``stream_service``)."""
