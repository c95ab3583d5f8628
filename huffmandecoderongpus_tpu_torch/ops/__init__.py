"""Host staging, the device program and the K1-K4 kernel wrappers."""
