"""``python -m lightgbm_tpu_torch config=train.conf [key=value ...]``: the
CLI entry point (reference src/main.cpp:11)."""
from .application import main

if __name__ == "__main__":
    main()
