"""Plain PyTorch references of the benchmark's configurations. They import
torch and numpy only: nothing of the program under test."""
