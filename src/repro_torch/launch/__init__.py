"""Launch helpers: the serving mesh (`mesh`)."""
