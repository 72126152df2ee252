"""pack_ms.stream: the benchmark's clock around its pack callback
(`merge_asks`, `pack_batch_cached`), ms per chunk over the window."""


def read(out):
    return out["layer"].get("pack_ms_per_chunk")
