"""Host-side helpers: image preprocessing, box geometry, `.env` loading and
the PAC-S renderings."""
