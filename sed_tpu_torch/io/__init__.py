"""Host-side audio reading."""
