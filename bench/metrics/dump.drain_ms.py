"""dump.drain_ms: the mean ``DumpImage.drain_ms`` (device-to-host fetch,
checksum check, blake2b) of the window's dumps that committed."""


def read(rec):
    ms = rec["drain_ms"]
    return sum(ms) / len(ms) if ms else None
