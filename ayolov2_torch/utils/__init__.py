"""Host-side helpers: sizing, serving defaults, device choice, weights."""
