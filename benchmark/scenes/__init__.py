"""Scene descriptions, one module a scene kind, found by the `kind` of a
configuration's `scene`: `describe(params, seed)` returns the plain
description (numpy geometry, materials, lights, camera) that both the
program and the reference are built from."""
