"""ID generation helpers (reference: helper/uuid)."""
import uuid


def generate_uuid() -> str:
    return str(uuid.uuid4())


def short_id(full: str) -> str:
    return full[:8]
