"""Audio IO (PCM16 WAV)."""
