"""Single-device extraction: candidate front end, probe, verify, results."""
