"""Host-side serving infrastructure: tick-phase attribution and the typed
errors the generation service raises."""
