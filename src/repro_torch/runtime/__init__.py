from .serve import ServeConfig, Server

__all__ = ["ServeConfig", "Server"]
