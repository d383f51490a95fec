# Port of src/repro/opt/__main__.py (the entry point under the __main__
# check, so importing the module runs nothing).
from .runner import main

if __name__ == "__main__":
    raise SystemExit(main())
