import sys

if len(sys.argv) > 1 and sys.argv[1] == "serve":
    raise NotImplementedError("the serving CLI is not yet ported to gptq_for_llama_tpu_torch "
                              "(ROADMAP A13)")
from .cli.main import main

main()
