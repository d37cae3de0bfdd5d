# Copied from gatekeeper_tpu/analysis/__main__.py; only this edit differs.
# Edit: main() runs under the `__main__` check, so importing the module
# (as the isolation tests import every module) runs nothing.
from .cli import main

if __name__ == "__main__":
    main()
