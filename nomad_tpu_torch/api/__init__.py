"""HTTP API layer + client SDK (reference: command/agent/http.go and
the api/ Go SDK); the counterpart of `nomad_tpu.api`."""
from .client import ApiClient, APIError
from .http_server import HTTPAgentServer, HTTPError

__all__ = ["ApiClient", "APIError", "HTTPAgentServer", "HTTPError"]
