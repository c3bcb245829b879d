"""Host-side batching helpers."""
