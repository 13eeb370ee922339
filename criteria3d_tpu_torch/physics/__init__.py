"""Process physics of the hourly model cycle (PyTorch)."""
