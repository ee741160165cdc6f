from dqmc_tpu_torch.run import main

main()
