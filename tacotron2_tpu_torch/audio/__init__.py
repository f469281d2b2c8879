"""Audio: WAV IO, FLAC decode, log-mel, Griffin-Lim, trimming, prosody features."""
