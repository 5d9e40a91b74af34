from .server import CodecHTTPServer, main  # noqa: F401
