"""Cloud serving for a fleet of headsets on one city tree (port of
`repro.serve`): `lod_service` (the batched LoD sync), `delta_path` (the
encode-once Δcut stream) and `fleet` (slot bookkeeping)."""
