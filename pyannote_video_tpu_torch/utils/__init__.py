"""Host utilities: device choice, numpy image ops, synthetic fixtures."""
