"""Host front-end and the three-phase parse engine."""
