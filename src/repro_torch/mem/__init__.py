"""Page-aligned communication-buffer arenas (port of ``repro.mem``)."""
