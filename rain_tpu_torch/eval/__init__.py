"""The LPIPS perceptual metric."""
